"""SRT post-formatting: typo substitutions, English re-segmentation, and
punctuation normalization (the port of ``vse_tpu/post/reformat.py``; the
typo table is the port's copy, ``vse_tpu_torch/assets/typo_map.json``).

Re-implements the behavior of the reference's reformat stage (reference
backend/tools/reformat.py:16-214): per-cue, apply the typoMap regex
substitutions, re-split concatenated English words (restoring contracted verb
forms like "im" -> "I'm"), split mixed CJK/EN lines, and run a fixed table of
punctuation/spacing fixes. Every cue is processed under its own try/except so
one malformed line can never corrupt the SRT (the reference wraps each line
the same way, reformat.py:108-200).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

from vse_tpu_torch.post.srt import SrtFile
from vse_tpu_torch.post.wordseg import Segmenter

# Contracted verb forms restored after segmentation (the segmenter lowercases
# and strips apostrophes; this maps the squashed form back).
VERB_FORMS = [
    "I'm", "you're", "he's", "she's", "we're", "it's", "isn't", "aren't",
    "they're", "there's", "wasn't", "weren't", "I've", "you've", "we've",
    "they've", "hasn't", "haven't", "I'd", "you'd", "he'd", "she'd", "it'd",
    "we'd", "they'd", "doesn't", "don't", "didn't", "I'll", "you'll",
    "he'll", "she'll", "we'll", "they'll", "there'll", "there'd", "can't",
    "couldn't", "daren't", "hadn't", "mightn't", "mustn't", "needn't",
    "oughtn't", "shan't", "shouldn't", "usedn't", "won't", "wouldn't",
    "that's", "what's", "it'll",
]

VERB_FORM_MAP: Dict[str, str] = {
    v.replace("'", "").lower(): v for v in VERB_FORMS
}


def default_typo_map_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets", "typo_map.json",
    )


def load_typo_map(path: Optional[str] = None) -> Dict[str, str]:
    path = path or default_typo_map_path()
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def typo_fix(text: str, typo_map: Dict[str, str]) -> str:
    """Case-insensitive regex substitution table (reference
    backend/tools/reformat.py:67-73)."""
    for pattern, repl in typo_map.items():
        try:
            text = re.sub(re.compile(pattern, re.I), repl, text)
        except re.error:
            continue
    return text


# The fixed punctuation/spacing pass (reference backend/tools/reformat.py:152-190),
# applied in order.
def punctuation_fixes(text: str) -> str:
    # space before an uppercase letter that follows a non-space/non-upper/non-dash
    text = re.sub(r"([^\sA-Z\-])([A-Z])", r"\1 \2", text)
    # collapse double spaces
    text = text.replace("  ", " ")
    # CJK full stop -> period
    text = text.replace("。", ".")
    # strip spaces before .?!,
    text = re.sub(r" *([\.\?\!\,])", r"\1", text)
    # strip spaces around apostrophes
    text = re.sub(r" *([\']) *", r"\1", text)
    # strip spaces after newlines, and leading whitespace
    text = re.sub(r"\n\s*", "\n", text)
    text = re.sub(r"^\s*", "", text)
    # join "word -suffix" -> "word-suffix"
    text = re.sub(r"([A-Za-z0-9]) (\-[A-Za-z0-9])", r"\1\2", text)
    # join "50 %" -> "50%"
    text = re.sub(r"([A-Za-z0-9]) %", r"\1%", text)
    # trailing middle dot -> period
    text = re.sub(r"·$", ".", text)
    # no space after "Dr."
    text = re.sub(r"\bDr\. *\b", "Dr.", text)
    # CJK quotes/comma -> ASCII
    text = re.sub(r"[“”]", '"', text)
    text = re.sub(r"，", ",", text)
    # space after sentence punctuation when glued to the next word
    text = re.sub(r"([\.,\!\?])([A-Za-z0-9一-龥])", r"\1 \2", text)
    text = text.replace("\n\n", "\n")
    return text.strip()


_ALNUM_RUN = re.compile(r"[A-Za-z][A-Za-z']*")


def resegment_text(text: str, segmenter: Segmenter) -> str:
    """Split concatenated English words in place.

    For each alphabetic run: if the segmenter splits it into multiple words
    (meaning it wasn't a single known word), replace the run with the
    space-joined split, restoring contraction verb forms and the original
    leading capitalization.
    """

    def fix_run(m: re.Match) -> str:
        run = m.group(0)
        bare = run.replace("'", "")
        if len(bare) <= 3:
            return run
        seg = segmenter.segment(bare)
        if len(seg) <= 1:
            return run
        words: List[str] = []
        for w in seg:
            words.append(VERB_FORM_MAP.get(w, w))
        out = " ".join(words)
        # restore original leading capitalization
        if run[0].isupper() and out and out[0].islower():
            out = out[0].upper() + out[1:]
        return out

    return _ALNUM_RUN.sub(fix_run, text)


def reformat_text(
    text: str,
    lang: str = "en",
    typo_map: Optional[Dict[str, str]] = None,
    segmenter: Optional[Segmenter] = None,
) -> str:
    """Full per-cue pipeline: typo fix -> CJK/EN line split -> re-segmentation
    -> typo fix again -> punctuation pass."""
    if typo_map is None:
        typo_map = load_typo_map()
    text = typo_fix(text, typo_map)
    # collapse multiple spaces before CJK (reference reformat.py:127)
    text = re.sub(r" +([一-龥])", r" \1", text)
    # CJK/EN split: double space becomes a line break for Chinese subs
    if lang in ("ch", "ch_tra", "chinese_cht"):
        text = text.replace("  ", "\n")
    if segmenter is not None and lang not in ("ch", "ch_tra", "chinese_cht"):
        text = resegment_text(text, segmenter)
    text = typo_fix(text, typo_map)
    return punctuation_fixes(text)


def execute(path: str, lang: str = "en") -> bool:
    """Process an SRT file in place (reference backend/tools/reformat.py:16).
    Returns True on success; per-cue failures keep the original text."""
    if not os.path.exists(path):
        return False
    try:
        subs = SrtFile.open(path)
    except (OSError, ValueError):
        return False
    typo_map = load_typo_map()
    segmenter = Segmenter()
    for item in subs:
        try:
            if not item.text or len(item.text) > 1000:
                continue
            item.text = reformat_text(item.text, lang, typo_map, segmenter)
        except Exception:
            continue  # never corrupt the SRT over one bad line
    try:
        subs.save(path)
        return True
    except OSError:
        return False
