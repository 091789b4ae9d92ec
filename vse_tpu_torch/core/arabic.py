"""Arabic, the decode side (the port of ``HOMOGLYPHS``,
``_reverse_keep_digit_runs`` and ``visual_to_logical`` of
``vse_tpu/core/arabic.py``; its contextual shaping and ``render_forms`` are
for drawing training text and are not needed here).

The arabic head reads visual order (right to left, as drawn); the engine
restores logical order with ``visual_to_logical``. It was trained with
pixel-identical glyph twins folded onto one class each (``HOMOGLYPHS``,
``core/charset.py::Charset.aliased``).
"""

from __future__ import annotations

from typing import List, Sequence


def _reverse_keep_digit_runs(seq: Sequence[str]) -> List[str]:
    """Full RTL reversal with maximal ASCII-digit runs kept LTR."""
    rev = list(reversed(seq))
    out: List[str] = []
    i = 0
    while i < len(rev):
        if rev[i].isascii() and rev[i].isdigit():
            j = i
            while j < len(rev) and rev[j].isascii() and rev[j].isdigit():
                j += 1
            out.extend(reversed(rev[i:j]))
            i = j
        else:
            out.append(rev[i])
            i += 1
    return out


def visual_to_logical(text: str) -> str:
    """Decode-side inverse of the visual label order."""
    return "".join(_reverse_keep_digit_runs(list(text)))


# Codepoint pairs whose glyphs are pixel-identical in the training font:
# Arabic-Indic vs Extended Arabic-Indic digits, heh/ae, alef-maksura/Farsi
# yeh. The charset folds each variant onto its canonical form, which alone
# keeps a class.
HOMOGLYPHS = {
    "ە": "ه",
    "ی": "ى",
    "۰": "٠",
    "۱": "١",
    "۲": "٢",
    "۳": "٣",
    "۷": "٧",
    "۸": "٨",
    "۹": "٩",
}
