"""Synthetic training data: rendered text lines (rec) and subtitle frames
(det) — the port of ``vse_tpu/train/synth.py``, drawing the same pixels
from the same seed, for every family.

The framework trains its own detector and recognizers on synthetic
burned-subtitle data: text rendered over procedural backgrounds with the
DejaVu fonts bundled with matplotlib. Labels: CTC id sequences for rec; DB
shrink/threshold maps for det (rect-box approximation of the Vatti offset).

PIL, matplotlib and fontTools are imported where they are used, so the
module imports without them (the card's machine has none and trains from a
pre-rendered dataset, ``train/pretrain.py``). The PIL-font families draw
with DejaVu, hangul with ``core/hangul.py``, arabic with ``core/arabic.py``,
and the families no font covers (``STROKE_FAMILIES``: th, devanagari, ta,
te, and the CJK families ch, chinese_cht, japan) from hand-authored strokes
(``core/strokefont.py`` and its script modules, ``core/cjk.py``).
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vse_tpu_torch.core.charset import Charset

# the families ``core/strokefont.py::stroke_script_for`` draws from
# hand-authored strokes
STROKE_FAMILIES = ("th", "devanagari", "ta", "te", "ch", "chinese_cht", "japan")


def _font_paths() -> List[str]:
    import matplotlib

    d = os.path.join(
        os.path.dirname(matplotlib.__file__), "mpl-data", "fonts", "ttf"
    )
    return sorted(glob.glob(os.path.join(d, "DejaVuSans*.ttf")))


@dataclass
class SynthConfig:
    rec_h: int = 48
    rec_w: int = 320
    det_h: int = 256
    det_w: int = 448
    min_font: int = 22
    max_font: int = 32
    shrink_ratio: float = 0.4
    max_label_len: int = 24
    # 0.0 = clean white-on-dark text; 1.0 = full augmentation (noisy
    # gradients, outlines, colored text). CTC training needs a curriculum —
    # full difficulty from scratch collapses to blanks.
    difficulty: float = 1.0
    # words-only text (no random character soup) — matches the subtitle
    # domain and converges much faster from scratch
    words_only: bool = False
    # force this stroke width when >= 0 (subtitle burn-ins have outlines)
    fixed_stroke: int = -1


def rec_render_config(difficulty: float = 1.0) -> SynthConfig:
    """The canonical rec-crop render profile shared by training dataset
    generation (train/pretrain.py) and the held-out gate (tools/eval_rec.py):
    subtitle-register words, burned-in outlines, near-full-height fonts.
    Fonts fill most of the 48-px canvas because the deployed crop path is
    ink-tight (ops/image.py refine_boxes_ink): production glyphs arrive at
    ~80% of the window, and renders born at 45-65% fill (the old 22-32
    fonts) would make every aug upscale y by ~1.5x."""
    return SynthConfig(words_only=True, fixed_stroke=2,
                       min_font=32, max_font=42, difficulty=difficulty)


def font_covered_chars(font_paths: Sequence[str], chars: Sequence[str]):
    """Subset of `chars` every font in `font_paths` has real glyphs for
    (exact cmap lookup via fontTools — bitmap heuristics mistake tofu boxes
    for coverage)."""
    from fontTools.ttLib import TTFont

    cov = None
    for p in font_paths:
        cm = set(TTFont(p, lazy=True).getBestCmap().keys())
        cov = cm if cov is None else (cov & cm)
    return [c for c in chars if all(ord(x) in (cov or set()) for x in c)]


class TextRenderer:
    def __init__(self, charset: Charset, cfg: SynthConfig = SynthConfig(), seed: int = 0):
        self.charset = charset
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.fonts = _font_paths()
        if not self.fonts:
            raise RuntimeError("no TTF fonts found (matplotlib DejaVu expected)")
        # the RENDER alphabet may differ from the label charset: a factored
        # charset (JamoCharset) labels positional jamo, but text is still
        # generated/drawn as syllables
        render_chars = getattr(charset, "render_chars", None) or charset.chars
        # restrict generation to chars the fonts actually cover — drawing
        # uncovered chars renders tofu boxes whose labels poison CTC; the
        # HEAD still spans the full family charset (ids come from `charset`).
        # Fonts that cover little of the charset are dropped first (the
        # matplotlib dir ships DejaVuSansDisplay.ttf with a 47-glyph cmap —
        # intersecting with it would zero every alphabet).
        per_font = {
            p: set(font_covered_chars([p], render_chars)) for p in self.fonts
        }
        best = max(len(v) for v in per_font.values())
        self.fonts = [
            p for p, v in per_font.items() if len(v) >= max(1, 0.9 * best)
        ]
        covered = set.intersection(*(per_font[p] for p in self.fonts))
        # charset order (not set order): keeps datasets reproducible
        self.alphabet = [c for c in render_chars if c in covered and c.strip()]
        # Hangul: no font covers it, but syllables compose programmatically
        # (vse_tpu/core/hangul.py) — the renderable alphabet is every
        # composable syllable plus whatever the fonts cover (digits etc.)
        self._hangul = charset.name == "korean"
        if self._hangul:
            from vse_tpu_torch.core.hangul import is_syllable

            self.alphabet = [
                c for c in render_chars
                if c.strip() and (is_syllable(c) or c in covered)
            ]
        # hand-authored stroke scripts (th/devanagari/ta/te — strokefont.py):
        # no covering font exists in this image, glyphs draw from polylines
        self._stroke = None
        if not self._hangul:
            from vse_tpu_torch.core.strokefont import stroke_script_for

            self._stroke = stroke_script_for(charset.name)
        if self._stroke is not None:
            self.alphabet = [
                c for c in render_chars
                if c.strip() and (self._stroke.covers(c) or c in covered)
            ]
            self._stroke_bases = [
                c for c in render_chars if c in self._stroke.glyphs
            ]
            self._stroke_marks = [
                c for c in render_chars if c in self._stroke.marks
            ]
            # frequency realism for BASES too: the core letter block
            # dominates real text; native digits / fractions / archaic
            # letters stay covered but rare (same rationale as the arabic
            # core weighting)
            if self._stroke.core_bases:
                core = set(self._stroke.core_bases)
                self._stroke_core = [
                    c for c in self._stroke_bases if c in core
                ] or self._stroke_bases
            else:
                lo, hi = {
                    "th": (0x0E01, 0x0E2E), "devanagari": (0x0904, 0x0939),
                    "ta": (0x0B85, 0x0BB9), "te": (0x0C05, 0x0C39),
                }.get(charset.name, (0, 0x10FFFF))
                self._stroke_core = [
                    c for c in self._stroke_bases if lo <= ord(c) <= hi
                ] or self._stroke_bases
        if not self.alphabet:
            raise RuntimeError(
                f"charset {charset.name!r}: the available fonts cover none of "
                f"its {len(render_chars)} characters — drop a covering TTF "
                "into the font path to train this family"
            )
        frac = len(self.alphabet) / max(1, len(render_chars))
        if frac < 0.5:
            import warnings

            warnings.warn(
                f"charset {charset.name!r}: fonts cover only "
                f"{len(self.alphabet)}/{len(render_chars)} chars; the "
                "trained head will not see the rest", stacklevel=2,
            )
        # Arabic: render shaped presentation forms in visual (RTL) order —
        # naive PIL draws produce isolated letterforms real subtitles never
        # show. Labels are visual-order base chars; the engine reverses
        # decoded text back to logical order (vse_tpu/core/arabic.py).
        self._arabic = charset.name == "arabic"
        if self._arabic:
            import unicodedata

            from fontTools.ttLib import TTFont
            from PIL import features

            # with libraqm PIL shapes+bidis Arabic natively: draw the
            # LOGICAL text and let raqm produce joined RTL output. Without
            # it, draw our own pre-shaped presentation forms in visual
            # order. Labels are visual-order base chars either way.
            self._raqm = bool(features.check("raqm"))
            glyph_cov = None
            for p in self.fonts:
                cm = {chr(c) for c in TTFont(p, lazy=True).getBestCmap()}
                glyph_cov = cm if glyph_cov is None else (glyph_cov & cm)
            self._glyph_coverage = glyph_cov or set()
            # standalone combining marks render as dotted circles — keep
            # them out of pseudo-words (the head keeps the classes, unseen)
            self.alphabet = [
                c for c in self.alphabet
                if unicodedata.category(c) != "Mn"
            ]
            # frequency realism: real Arabic-script subtitles are dominated
            # by the core U+0621-064A letters; a uniform soup over the full
            # ~110-char family (incl. rare Farsi/Urdu extension letters that
            # differ only by dot placement) makes both training and eval
            # unrealistically adversarial
            self._core_arabic = [
                c for c in self.alphabet if 0x0621 <= ord(c) <= 0x064A
            ]
        # English words only make sense for heads that contain ascii letters;
        # other scripts get pseudo-words drawn from their own alphabet. Heads
        # with non-ascii chars (latin accents, mixed heads) mix in pseudo-
        # words so those glyphs appear in training at all.
        self._ascii_words = all(c in charset.chars for c in "etaoinshrd")
        self._pseudo_share = (
            0.0 if all(ord(c) < 128 for c in self.alphabet) else 0.25
        )
        from vse_tpu_torch.train.wordlists import NATIVE_WORDS

        self._native_words: List[str] = []
        self._native_core: List[str] = []
        self._native_pool: List[str] = []
        if charset.name in ("el", "cyrillic"):
            # native-script-majority heads: their dicts carry ascii too, so
            # `_ascii_words` holds — but a 75%-English diet leaves the
            # native glyphs undertrained and the held-out gate measuring
            # mostly English. Observed e2e: el read Greek with Latin
            # homoglyphs (τ→t) at CER 0.61 while gating at 0.04. Explicitly
            # NOT latin: its alphabet is accent-majority but its real-world
            # text is European-language words, so the English-word diet
            # stays at 75% there (ADVICE r4 #2).
            self._pseudo_share = 0.75
            # …but the native share must be WORDS, not uniform char-soup:
            # these dicts contain pixel-identical cross-script homoglyphs
            # (х/x, о/o, с/c; ο/o) plus rare archaic letters and standalone
            # combining marks, so soup has an irreducible CER floor far
            # above the 0.05 gate (r5 measured: cyrillic plateaued at 0.27
            # with probe-exact 0/4 ON ITS OWN TRAINING BATCHES). Real words
            # in a single script per word give the BiLSTM the script-
            # consistency prior that actually disambiguates homoglyphs —
            # the synthetic stand-in for the real-text corpora the
            # reference's heads are trained on.
            import unicodedata

            renderable = set(self.alphabet)
            self._native_words = [
                w for w in NATIVE_WORDS[charset.name]
                if all(c in renderable for c in w)
                and len(charset.encode(w)) == len(w)
            ]
            # soup pools exclude standalone combining marks (PIL stacks
            # them on the previous glyph — same exclusion arabic applies)
            self._native_pool = [
                c for c in self.alphabet
                if unicodedata.category(c) != "Mn"
            ]
            core = set(
                "άέήίόύώςϊϋΐΰ" if charset.name == "el"
                else "ёіїєґўјђћљњџ"
            )
            lo, hi = (
                (0x03B1, 0x03C9) if charset.name == "el"
                else (0x0430, 0x044F)
            )
            self._native_core = [
                c for c in self._native_pool
                if lo <= ord(c) <= hi or c in core
            ] or self._native_pool
        elif charset.name in NATIVE_WORDS:
            # r5: every scripted family gets a real-word majority — uniform
            # soup over dot-diacritic alphabets (ت/ث/ٿ, ि/ी matras, thai
            # tone stacks) has an irreducible CER floor at crop resolution
            # (ar trained from scratch on core-weighted soup still gated at
            # 0.21); word-sequence priors are what the reference's heads
            # get from their real-text corpora. Renders keep the script's
            # own composer/shaper path; words with unrenderable chars drop.
            renderable = set(self.alphabet)
            self._native_words = [
                w for w in NATIVE_WORDS[charset.name]
                if all(c in renderable for c in w) and charset.encode(w)
            ]
        if self._native_words and charset.name not in ("latin",):
            # native-script majority (latin stays English-majority: its
            # real-world text is European-language words, ADVICE r4 #2)
            self._pseudo_share = max(self._pseudo_share, 0.75)
        if self._hangul:
            # the korean dict contains ascii too, but the head's job is
            # Hangul — keep English word lines a small minority
            self._pseudo_share = 0.75
        if self._stroke is not None and charset.name in (
                "ch", "chinese_cht", "japan"):
            # CJK dicts contain ascii too, but the heads' job is the
            # ideograph/kana core (same rationale as the hangul share)
            self._pseudo_share = 0.75

    # common words give the recognizer realistic glyph sequences (the word
    # segmenter's frequency list, ~2k words); random chars keep full charset
    # coverage
    from vse_tpu_torch.post.wordseg import _COMMON as _WORDS  # noqa: N815

    def _pseudo_word(self) -> str:
        # native share: 60% real words (wordlists.py — the letter-sequence
        # priors that disambiguate homoglyphs and dot-diacritic families),
        # else the script's own soup (core-weighted / orthographic) for
        # full charset class coverage
        if self._native_words and self.rng.random() < 0.6:
            w = str(self.rng.choice(self._native_words))
            if self.rng.random() < 0.2:
                w = w.capitalize()
            return w
        if self._stroke is not None and getattr(self, "_stroke_bases", None):
            return self._stroke_word()
        if self._native_pool:
            # el/cyrillic: core-weighted single-script soup (90% modern-
            # letter core, 10% full pool for rare-glyph class coverage)
            pool = (
                self._native_core
                if self.rng.random() < 0.9
                else self._native_pool
            )
            k = int(self.rng.integers(2, 9))
            return "".join(
                str(self.rng.choice(pool)) for _ in range(k)
            ).strip()
        if self._arabic and getattr(self, "_core_arabic", None):
            k = int(self.rng.integers(2, 9))
            return "".join(
                str(self.rng.choice(self._core_arabic))
                if self.rng.random() < 0.85
                else str(self.rng.choice(self.alphabet))
                for _ in range(k)
            ).strip()
        k = int(self.rng.integers(2, 9))
        return "".join(
            str(self.rng.choice(self.alphabet)) for _ in range(k)
        ).strip()

    def random_text(self, min_len=3, max_len=18) -> str:
        n = int(self.rng.integers(min_len, max_len + 1))
        word_p = 1.0 if self.cfg.words_only else 0.6
        parts = []
        length = 0
        while length < n:
            if (
                self.rng.random() < word_p
                and self._ascii_words
                and self.rng.random() >= self._pseudo_share
            ):
                w = str(self.rng.choice(self._WORDS))
                if self.rng.random() < 0.3:
                    w = w.capitalize()
            else:
                w = self._pseudo_word()
            if w:
                parts.append(w)
                length += len(w) + 1
        return " ".join(parts)[: max_len + 6].strip()

    def _bg(self, w: int, h: int) -> np.ndarray:
        """Procedural background: gradient + noise, scaled by difficulty."""
        d = self.cfg.difficulty
        base = self.rng.uniform(10, 30 + 130 * d)
        amp = 40 * d
        gx = np.linspace(0, self.rng.uniform(-amp, amp), w)
        gy = np.linspace(0, self.rng.uniform(-amp, amp), h)
        img = base + gx[None, :] + gy[:, None]
        img = img[..., None] + self.rng.normal(0, 1 + 5 * d, size=(h, w, 3))
        return np.clip(img, 0, 255).astype(np.uint8)

    def _stroke_word(self) -> str:
        """Orthographic pseudo-word for a stroke script: base consonants
        with slot-appropriate combining vowels/tones in the script's
        STORAGE order (thai stores pre-vowels before the consonant; indic
        scripts store pre-matras after — labels must match real-text label
        order, the renderer reorders at draw time). Marks draw from the
        script's common set 85% of the time (uniform sampling over the full
        table stacks rare vedic signs real subtitles never show)."""
        s = self._stroke
        if not hasattr(self, "_slot_cache"):
            by_slot = {"pre": [], "post": [], "above0": [], "above1": [],
                       "below": []}
            for c in self._stroke_marks:
                m = s.marks[c]
                key = (
                    "above0" if (m.slot == "above" and m.level == 0)
                    else "above1" if m.slot == "above" else m.slot
                )
                by_slot[key].append(c)
            self._slot_cache = by_slot
        sl = self._slot_cache
        common = set(s.common_marks)

        def pick(pool):
            cp = [c for c in pool if c in common]
            if cp and self.rng.random() < 0.85:
                return str(self.rng.choice(cp))
            return str(self.rng.choice(pool))

        out = []
        for _ in range(int(self.rng.integers(2, 6))):
            pre = None
            if sl["pre"] and self.rng.random() < 0.18:
                pre = pick(sl["pre"])
            if pre is not None and s.pre_stored_before:
                out.append(pre)
            if self.rng.random() < 0.85:
                out.append(str(self.rng.choice(self._stroke_core)))
            else:
                out.append(str(self.rng.choice(self._stroke_bases)))
            if pre is not None and not s.pre_stored_before:
                out.append(pre)
            r = self.rng.random()
            if sl["above0"] and r < 0.25:
                out.append(pick(sl["above0"]))
            elif sl["below"] and r < 0.40:
                out.append(pick(sl["below"]))
            if sl["above1"] and self.rng.random() < 0.18:
                out.append(pick(sl["above1"]))
            if sl["post"] and self.rng.random() < 0.20:
                out.append(pick(sl["post"]))
        return "".join(out)

    def render_line(self, text: Optional[str] = None) -> Tuple[np.ndarray, str]:
        """One rec training crop [rec_h, rec_w, 3] uint8 + its text.

        The text is measured and trimmed to fit the crop — labels must match
        exactly what is drawn (clipped glyphs with full labels poison CTC
        supervision)."""
        cfg = self.cfg
        from PIL import Image, ImageDraw, ImageFont

        if text is None:
            text = self.random_text()
        fpath = str(self.rng.choice(self.fonts))
        fsize = int(self.rng.integers(cfg.min_font, cfg.max_font + 1))
        font = ImageFont.truetype(fpath, fsize)
        img = Image.fromarray(self._bg(cfg.rec_w, cfg.rec_h))
        draw = ImageDraw.Draw(img)
        x = int(self.rng.integers(2, 12))
        y = int(self.rng.integers(0, 6))

        def glyphs_and_label(t):
            if self._arabic:
                from vse_tpu_torch.core.arabic import render_forms

                glyphs, label = render_forms(t, self._glyph_coverage)
                if self._raqm:
                    return t, label  # raqm shapes the logical text itself
                return glyphs, label
            return t, t

        if self._hangul:
            return self._render_line_hangul(img, draw, text, x, font)
        if self._stroke is not None:
            return self._render_line_stroke(img, draw, text, x, font)
        # explicit RTL paragraph direction keeps raqm's bidi in lockstep
        # with the visual-order labels even for digit-leading lines
        draw_kw = (
            {"direction": "rtl"}
            if self._arabic and getattr(self, "_raqm", False)
            else {}
        )
        # vertical-fit guard: near-full-height fonts (rec_render_config)
        # can overflow the crop for scripts with tall accent stacks, and
        # the trim loop below only shrinks text LENGTH — a too-tall font
        # would trim to the empty-text fallback and draw one clipped glyph
        # under a full label (poisoned CTC supervision). Scale the FONT to
        # fit instead.
        glyphs, label = glyphs_and_label(text)
        for _ in range(2):
            bbox = draw.textbbox((x, y), glyphs, font=font, stroke_width=2,
                                 **draw_kw)
            if bbox[3] <= cfg.rec_h - 1:
                break
            fsize = max(10, int(fsize * (cfg.rec_h - 1 - y)
                                / max(1, bbox[3] - y)))
            font = ImageFont.truetype(fpath, fsize)
        # trim until the rendered text fits the crop width/height
        while text:
            glyphs, label = glyphs_and_label(text)
            bbox = draw.textbbox((x, y), glyphs, font=font, stroke_width=2,
                                 **draw_kw)
            if bbox[2] <= cfg.rec_w - 2 and bbox[3] <= cfg.rec_h:
                break
            text = text[:-1].rstrip()
        if not text:
            text = str(self.rng.choice(self.alphabet)).strip() or "a"
            glyphs, label = glyphs_and_label(text)
        # white (or, at high difficulty, yellow) text with dark outline
        d = self.cfg.difficulty
        fill = (255, 255, 255)
        if self.rng.random() < 0.3 * d:
            fill = (255, 255, 0)
        if self.cfg.fixed_stroke >= 0:
            stroke = self.cfg.fixed_stroke
        else:
            stroke = 2 if self.rng.random() < d else 0
        draw.text((x, y), glyphs, font=font, fill=fill,
                  stroke_width=stroke, stroke_fill=(0, 0, 0), **draw_kw)
        return np.asarray(img, np.uint8), label

    def _render_line_hangul(self, img, draw, text, x, font):
        """Korean rec crop: stroke-composed syllables (core/hangul.py),
        PIL-font fallback for non-Hangul chars."""
        from vse_tpu_torch.core.hangul import render_hangul_text, text_width

        cfg = self.cfg
        size = min(font.size, cfg.rec_h - 8)
        y = int(self.rng.integers(0, max(1, cfg.rec_h - size - 4)))
        while text and text_width(text, size, font, draw) > cfg.rec_w - x - 2:
            text = text[:-1].rstrip()
        if not text:
            text = str(self.rng.choice(self.alphabet)).strip()
        d = self.cfg.difficulty
        fill = (255, 255, 0) if self.rng.random() < 0.3 * d else (255, 255, 255)
        if self.cfg.fixed_stroke >= 0:
            stroke = self.cfg.fixed_stroke
        else:
            stroke = 2 if self.rng.random() < d else 0
        render_hangul_text(draw, (x, y), text, size, font, fill=fill,
                           stroke_width=stroke, stroke_fill=(0, 0, 0))
        return np.asarray(img, np.uint8), text

    def _render_line_stroke(self, img, draw, text, x, font):
        """Stroke-script rec crop (th/devanagari/ta/te): hand-authored
        glyph composition (core/strokefont.py), PIL-font fallback for
        font-covered chars (digits/punctuation)."""
        from vse_tpu_torch.core.strokefont import draw_text, line_width

        s = self._stroke
        cfg = self.cfg
        size = min(font.size + 10, cfg.rec_h - 10)
        y = int(self.rng.integers(0, max(1, cfg.rec_h - size - 4)))

        def width_of(t: str) -> int:
            w, seg = 0, []
            for ch in t:
                if s.covers(ch) or ch == " ":
                    seg.append(ch)
                else:
                    if seg:
                        w += line_width(s, "".join(seg), size)
                        seg = []
                    w += int(draw.textlength(ch, font=font)) + 2
            if seg:
                w += line_width(s, "".join(seg), size)
            return w

        while text and width_of(text) > cfg.rec_w - x - 2:
            text = text[:-1].rstrip()
        if not text:
            text = str(self.rng.choice(self._stroke_bases))
        d = self.cfg.difficulty
        fill = (255, 255, 0) if self.rng.random() < 0.3 * d else (255, 255, 255)
        if self.cfg.fixed_stroke >= 0:
            stroke = self.cfg.fixed_stroke
        else:
            stroke = 2 if self.rng.random() < d else 0
        cx, seg = x, []

        def flush_seg():
            nonlocal cx, seg
            if seg:
                cx += draw_text(
                    draw, (cx, y), "".join(seg), size, s, fill=fill,
                    stroke_width=stroke, stroke_fill=(0, 0, 0),
                )
                seg = []

        for ch in text:
            if s.covers(ch) or ch == " ":
                seg.append(ch)
            else:
                flush_seg()
                draw.text((cx, y + size // 5), ch, font=font, fill=fill,
                          stroke_width=stroke, stroke_fill=(0, 0, 0))
                cx += int(draw.textlength(ch, font=font)) + 2
        flush_seg()
        return np.asarray(img, np.uint8), text

    def rec_batch(self, batch: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        imgs = np.zeros((batch, cfg.rec_h, cfg.rec_w, 3), np.uint8)
        labels = np.zeros((batch, cfg.max_label_len), np.int32)
        lengths = np.zeros((batch,), np.int32)
        texts = []
        for i in range(batch):
            while True:
                img, text = self.render_line()
                ids = self.charset.encode(text)[: cfg.max_label_len]
                if ids:
                    break
            imgs[i] = img
            labels[i, : len(ids)] = ids
            lengths[i] = len(ids)
            texts.append(text)
        return {
            "rec_images": imgs,
            "labels": labels,
            "label_lengths": lengths,
            "texts": texts,
        }

    # --- det ---------------------------------------------------------------

    def render_frame(self) -> Tuple[np.ndarray, List[Tuple[int, int, int, int]]]:
        """A det training frame [det_h, det_w, 3] + text boxes (xyxy)."""
        from PIL import Image, ImageDraw, ImageFont

        cfg = self.cfg
        img = Image.fromarray(self._bg(cfg.det_w, cfg.det_h))
        draw = ImageDraw.Draw(img)
        boxes = []
        n_lines = int(self.rng.integers(1, 3))
        for _ in range(n_lines):
            text = self.random_text(4, 14)
            font = ImageFont.truetype(
                str(self.rng.choice(self.fonts)),
                int(self.rng.integers(cfg.min_font, cfg.max_font + 1)),
            )
            bbox = draw.textbbox((0, 0), text, font=font, stroke_width=2)
            tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
            if tw >= cfg.det_w - 8 or th >= cfg.det_h - 8:
                continue
            x = int(self.rng.integers(4, cfg.det_w - tw - 4))
            y = int(self.rng.integers(4, cfg.det_h - th - 4))
            draw.text((x - bbox[0], y - bbox[1]), text, font=font,
                      fill=(255, 255, 255), stroke_width=2, stroke_fill=(0, 0, 0))
            boxes.append((x, y, x + tw, y + th))
        return np.asarray(img, np.uint8), boxes

    def det_labels(
        self, boxes: Sequence[Tuple[int, int, int, int]]
    ) -> Dict[str, np.ndarray]:
        """DB targets for rect boxes: shrink map (box inset by the DB offset
        d = A(1-r^2)/L), threshold map (linear ramp in the border band),
        and their masks."""
        cfg = self.cfg
        H, W = cfg.det_h, cfg.det_w
        shrink = np.zeros((H, W), np.float32)
        thresh = np.zeros((H, W), np.float32)
        thresh_mask = np.zeros((H, W), np.float32)
        r = cfg.shrink_ratio
        for (x0, y0, x1, y1) in boxes:
            bw, bh = x1 - x0, y1 - y0
            if bw <= 2 or bh <= 2:
                continue
            area, perim = bw * bh, 2 * (bw + bh)
            d = max(1, int(round(area * (1 - r * r) / perim)))
            sx0, sy0 = x0 + d, y0 + d
            sx1, sy1 = x1 - d, y1 - d
            if sx1 > sx0 and sy1 > sy0:
                shrink[sy0:sy1, sx0:sx1] = 1.0
            # threshold band: dilate box by d; ramp = 1 - dist/d clipped
            ex0, ey0 = max(0, x0 - d), max(0, y0 - d)
            ex1, ey1 = min(W, x1 + d), min(H, y1 + d)
            ys, xs = np.mgrid[ey0:ey1, ex0:ex1]
            dx = np.maximum(np.maximum(x0 - xs, xs - x1), 0)
            dy = np.maximum(np.maximum(y0 - ys, ys - y1), 0)
            dist_out = np.sqrt(dx * dx + dy * dy)
            inx = np.minimum(xs - x0, x1 - xs)
            iny = np.minimum(ys - y0, y1 - ys)
            dist_in = np.maximum(np.minimum(inx, iny), 0)
            dist = np.where(dist_out > 0, dist_out, dist_in)
            band = np.clip(1.0 - dist / d, 0, 1)
            thresh[ey0:ey1, ex0:ex1] = np.maximum(thresh[ey0:ey1, ex0:ex1], band)
            thresh_mask[ey0:ey1, ex0:ex1] = 1.0
        # DB thresh target lives in [0.3, 0.7]
        thresh = 0.3 + 0.4 * thresh
        return {
            "gt_shrink": shrink,
            "gt_shrink_mask": np.ones((H, W), np.float32),
            "gt_thresh": thresh,
            "gt_thresh_mask": thresh_mask,
        }

    def det_batch(self, batch: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        out = {
            "det_images": np.zeros((batch, cfg.det_h, cfg.det_w, 3), np.uint8),
            "gt_shrink": np.zeros((batch, cfg.det_h, cfg.det_w), np.float32),
            "gt_shrink_mask": np.zeros((batch, cfg.det_h, cfg.det_w), np.float32),
            "gt_thresh": np.zeros((batch, cfg.det_h, cfg.det_w), np.float32),
            "gt_thresh_mask": np.zeros((batch, cfg.det_h, cfg.det_w), np.float32),
            "boxes": [],
        }
        for i in range(batch):
            img, boxes = self.render_frame()
            labels = self.det_labels(boxes)
            out["det_images"][i] = img
            for k, v in labels.items():
                out[k][i] = v
            out["boxes"].append(boxes)
        return out

    def combined_batch(self, batch: int) -> Dict[str, np.ndarray]:
        """One batch feeding the combined det+rec train step."""
        det = self.det_batch(batch)
        rec = self.rec_batch(batch)
        out = {**det, **rec}
        out["det_images"] = out["det_images"].astype(np.float32) / 255.0
        out["det_images"] = (out["det_images"] - np.array([0.485, 0.456, 0.406])) / np.array([0.229, 0.224, 0.225])
        out["det_images"] = out["det_images"].astype(np.float32)
        out["rec_images"] = ((out["rec_images"].astype(np.float32) / 255.0) - 0.5) / 0.5
        out.pop("boxes")
        out.pop("texts")
        return out
