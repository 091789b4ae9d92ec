"""Character sets of the rec heads (the parts of the JAX package's charset
module that the ported families need).

A language maps onto a script family (``script_family``), and the family
names the rec head and its character set. ``en`` is built in; the dict
families read a one-character-per-line file (the PaddleOCR format) from the
port's own copy under ``vse_tpu_torch/assets/dicts/<family>.txt``. This
slice ports ``en`` and ``ch``; the other families raise until their heads,
dict files and decode passes are ported.

CTC convention: index 0 is the blank; characters are 1..N. A trailing space
character is appended when ``use_space_char`` (PaddleOCR-compatible). A rec
head's ``vse_meta.json`` says which variant its classes were trained on
(``fold_case``, ``use_space_char``); ``OcrEngine`` applies them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

# Deterministic ASCII charset (printable ASCII minus control chars).
EN_CHARS = (
    "0123456789"
    "abcdefghijklmnopqrstuvwxyz"
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"
)

# Language -> script family (reference backend/tools/paddle_model_config.py:25-45)
LATIN_LANGS = (
    "af", "az", "bs", "cs", "cy", "da", "de", "es", "et", "fr", "ga", "hr",
    "hu", "id", "is", "it", "ku", "la", "lt", "lv", "mi", "ms", "mt", "nl",
    "no", "oc", "pi", "pl", "pt", "ro", "rs_latin", "sk", "sl", "sq", "sv",
    "sw", "tl", "tr", "uz", "vi", "french", "german",
)
ARABIC_LANGS = ("ar", "fa", "ug", "ur")
CYRILLIC_LANGS = (
    "ru", "rs_cyrillic", "be", "bg", "uk", "mn", "abq", "ady", "kbd", "ava",
    "dar", "inh", "che", "lbe", "lez", "tab",
)
DEVANAGARI_LANGS = (
    "hi", "mr", "ne", "bh", "mai", "ang", "bho", "mah", "sck", "new", "gom",
    "sa", "bgc",
)

DICT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "dicts"
)
# families whose head, dict file and decode passes are ported
PORTED_DICT_FAMILIES = ("ch",)
# every ported family: en's charset is built in
PORTED_FAMILIES = ("en",) + PORTED_DICT_FAMILIES


def script_family(language: str) -> str:
    """Map a language code to its rec-head script family (reference
    paddle_model_config.py:84-91)."""
    if language in LATIN_LANGS:
        return "latin"
    if language in ARABIC_LANGS:
        return "arabic"
    if language in CYRILLIC_LANGS:
        return "cyrillic"
    if language in DEVANAGARI_LANGS:
        return "devanagari"
    return language  # ch, en, korean, japan, chinese_cht, ta, te, ka, th, el


@dataclass(frozen=True)
class Charset:
    """Immutable charset with the CTC blank at index 0."""

    name: str
    chars: Tuple[str, ...]
    use_space_char: bool = True

    def __post_init__(self):
        if self.use_space_char and " " not in self.chars:
            object.__setattr__(self, "chars", tuple(self.chars) + (" ",))

    @property
    def vocab_size(self) -> int:
        return len(self.chars)

    def decode_ids(self, ids: Sequence[int]) -> str:
        """Non-blank, already-deduped ids -> text."""
        return "".join(
            self.chars[i - 1] for i in ids if 1 <= i <= len(self.chars)
        )

    def without_space(self) -> "Charset":
        """Space-class-free variant."""
        return Charset(self.name, tuple(c for c in self.chars if c != " "), False)

    def folded(self) -> "Charset":
        """Case-folded variant: lowercase letters only (the head reads
        either case as one class)."""
        seen: List[str] = []
        for c in self.chars:
            if c.lower() not in seen:
                seen.append(c.lower())
        return Charset(self.name, tuple(seen), self.use_space_char)

    @classmethod
    def from_file(cls, name: str, path: str, use_space_char: bool = True) -> "Charset":
        """Load a one-character-per-line dict file (PaddleOCR format): every
        non-empty line once ``\\n`` / ``\\r`` are stripped, so a line that
        holds one space stays."""
        chars = []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n").rstrip("\r")
                if line:
                    chars.append(line)
        return cls(name=name, chars=tuple(chars), use_space_char=use_space_char)


_LOADED: Dict[str, Charset] = {}


def get_charset(language: str) -> Charset:
    """The charset of a language's script family: ``en`` built in, the
    ported dict families from ``DICT_DIR``."""
    family = script_family(language)
    if family in _LOADED:
        return _LOADED[family]
    if family == "en":
        cs = Charset(name="en", chars=tuple(EN_CHARS))
    elif family in PORTED_DICT_FAMILIES:
        cs = Charset.from_file(family, os.path.join(DICT_DIR, f"{family}.txt"))
    else:
        raise NotImplementedError(
            f"script family {family!r} (language {language!r}) is not ported "
            f"yet; this slice of the port supports "
            f"{', '.join(repr(f) for f in PORTED_FAMILIES)}"
        )
    _LOADED[family] = cs
    return cs
