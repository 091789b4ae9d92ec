"""Cross-script homoglyph fold for the bilingual cyrillic and greek heads
(the port of ``normalize_script`` of ``vse_tpu/post/homoglyph.py``).

The cyrillic and el charsets hold both the native script and basic latin,
and many letter pairs are pixel-identical across the two (а/a, е/e, о/o,
...), so the head emits an arbitrary member of each twin pair. A per-line
majority vote picks the dominant script and folds every twin toward it;
ties go to the native script.
"""

from __future__ import annotations

from typing import Dict

# latin -> cyrillic twins
_L2CYR: Dict[str, str] = {
    "a": "а", "c": "с", "e": "е", "o": "о", "p": "р", "x": "х", "y": "у",
    "i": "і", "s": "ѕ", "j": "ј",
    "A": "А", "B": "В", "C": "С", "E": "Е", "H": "Н", "I": "І", "J": "Ј",
    "K": "К", "M": "М", "O": "О", "P": "Р", "S": "Ѕ", "T": "Т", "X": "Х",
    "Y": "У", "3": "З", "6": "б",
}
# 3 and 6 fold only on a line with no other digit (a timestamp like 3:16
# must survive)
_DIGIT_FOLDS = {"3", "6"}

# latin -> greek twins
_L2EL: Dict[str, str] = {
    "o": "ο", "v": "ν", "u": "υ", "n": "η",
    "A": "Α", "B": "Β", "E": "Ε", "Z": "Ζ", "H": "Η", "I": "Ι", "K": "Κ",
    "M": "Μ", "N": "Ν", "O": "Ο", "P": "Ρ", "T": "Τ", "Y": "Υ", "X": "Χ",
}

_CYR2L = {v: k for k, v in _L2CYR.items() if k not in _DIGIT_FOLDS}
_EL2L = {v: k for k, v in _L2EL.items()}


def _script_of(ch: str) -> str:
    o = ord(ch)
    if 0x0400 <= o <= 0x052F:
        return "cyrillic"
    if 0x0370 <= o <= 0x03FF or 0x1F00 <= o <= 0x1FFF:
        return "greek"
    if ch.isalpha() and o < 0x250:
        return "latin"
    return ""


def normalize_script(text: str, family: str) -> str:
    """Fold homoglyph twins toward the line's majority script. ``family``
    is the rec head's ('cyrillic' or 'el'); others pass through."""
    if family == "cyrillic":
        native, to_native, to_latin = "cyrillic", _L2CYR, _CYR2L
    elif family == "el":
        native, to_native, to_latin = "greek", _L2EL, _EL2L
    else:
        return text
    counts = {"latin": 0, native: 0}
    for ch in text:
        s = _script_of(ch)
        if s in counts:
            counts[s] += 1
    if not counts["latin"] and not counts[native]:
        return text
    if counts[native] >= counts["latin"]:
        has_digits = any(c.isdigit() and c not in _DIGIT_FOLDS for c in text)
        return "".join(
            ch if ch in _DIGIT_FOLDS and has_digits else to_native.get(ch, ch)
            for ch in text
        )
    return "".join(to_latin.get(ch, ch) for ch in text)
