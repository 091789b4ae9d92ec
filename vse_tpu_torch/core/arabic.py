"""Arabic contextual shaping + visual ordering (the port of
``vse_tpu/core/arabic.py``, a copy): ``visual_to_logical`` and
``HOMOGLYPHS`` for the engine's decode, ``shape`` and ``render_forms`` for
``train/synth.py``'s training lines.

Arabic contextual shaping + visual ordering (host-side, self-contained).

The reference gets shaped Arabic "for free": PaddleOCR's arabic rec models
were trained upstream on real shaped text (reference
backend/tools/paddle_model_config.py:31 routes ar/fa/ug/ur to the arabic
head). Training our own head from rendered text needs the shaping step PIL
lacks: naive draws produce isolated, unjoined letterforms, which real
subtitles never show.

This module implements the Unicode joining algorithm over the Arabic
Presentation Forms A/B glyphs DejaVu provides (141 B-forms + 108 A-forms):

- `shape(text)`: logical-order text -> [(base_char, glyph)] with
  isolated/initial/medial/final forms and the mandatory lam-alef ligatures;
- `to_visual(pairs)`: RTL reversal with digit runs kept LTR;
- `render_forms(text, coverage)`: (visual_glyph_string, visual_base_label)
  for the synth renderer — glyphs are drawn, the base-char label is what
  the CTC head learns (visual order; the engine reverses decoded text back
  to logical order, `visual_to_logical`).
"""

from __future__ import annotations

import unicodedata
from typing import Iterable, List, Optional, Sequence, Set, Tuple

# base -> (isolated, final, initial, medial); None = form doesn't exist
# (right-joining letters have no initial/medial). Unicode Arabic
# Presentation Forms-B (U+FE70..FEFF) + Forms-A (Farsi/Urdu letters).
_FORMS = {
    "ء": (0xFE80, None, None, None),      # hamza
    "آ": (0xFE81, 0xFE82, None, None),    # alef madda
    "أ": (0xFE83, 0xFE84, None, None),    # alef hamza above
    "ؤ": (0xFE85, 0xFE86, None, None),    # waw hamza
    "إ": (0xFE87, 0xFE88, None, None),    # alef hamza below
    "ئ": (0xFE89, 0xFE8A, 0xFE8B, 0xFE8C),  # yeh hamza
    "ا": (0xFE8D, 0xFE8E, None, None),    # alef
    "ب": (0xFE8F, 0xFE90, 0xFE91, 0xFE92),  # beh
    "ة": (0xFE93, 0xFE94, None, None),    # teh marbuta
    "ت": (0xFE95, 0xFE96, 0xFE97, 0xFE98),  # teh
    "ث": (0xFE99, 0xFE9A, 0xFE9B, 0xFE9C),  # theh
    "ج": (0xFE9D, 0xFE9E, 0xFE9F, 0xFEA0),  # jeem
    "ح": (0xFEA1, 0xFEA2, 0xFEA3, 0xFEA4),  # hah
    "خ": (0xFEA5, 0xFEA6, 0xFEA7, 0xFEA8),  # khah
    "د": (0xFEA9, 0xFEAA, None, None),    # dal
    "ذ": (0xFEAB, 0xFEAC, None, None),    # thal
    "ر": (0xFEAD, 0xFEAE, None, None),    # reh
    "ز": (0xFEAF, 0xFEB0, None, None),    # zain
    "س": (0xFEB1, 0xFEB2, 0xFEB3, 0xFEB4),  # seen
    "ش": (0xFEB5, 0xFEB6, 0xFEB7, 0xFEB8),  # sheen
    "ص": (0xFEB9, 0xFEBA, 0xFEBB, 0xFEBC),  # sad
    "ض": (0xFEBD, 0xFEBE, 0xFEBF, 0xFEC0),  # dad
    "ط": (0xFEC1, 0xFEC2, 0xFEC3, 0xFEC4),  # tah
    "ظ": (0xFEC5, 0xFEC6, 0xFEC7, 0xFEC8),  # zah
    "ع": (0xFEC9, 0xFECA, 0xFECB, 0xFECC),  # ain
    "غ": (0xFECD, 0xFECE, 0xFECF, 0xFED0),  # ghain
    "ف": (0xFED1, 0xFED2, 0xFED3, 0xFED4),  # feh
    "ق": (0xFED5, 0xFED6, 0xFED7, 0xFED8),  # qaf
    "ك": (0xFED9, 0xFEDA, 0xFEDB, 0xFEDC),  # kaf
    "ل": (0xFEDD, 0xFEDE, 0xFEDF, 0xFEE0),  # lam
    "م": (0xFEE1, 0xFEE2, 0xFEE3, 0xFEE4),  # meem
    "ن": (0xFEE5, 0xFEE6, 0xFEE7, 0xFEE8),  # noon
    "ه": (0xFEE9, 0xFEEA, 0xFEEB, 0xFEEC),  # heh
    "و": (0xFEED, 0xFEEE, None, None),    # waw
    "ى": (0xFEEF, 0xFEF0, None, None),    # alef maksura
    "ي": (0xFEF1, 0xFEF2, 0xFEF3, 0xFEF4),  # yeh
    # Forms-A: Farsi / Urdu
    "ٹ": (0xFB66, 0xFB67, 0xFB68, 0xFB69),  # tteh (Urdu)
    "پ": (0xFB56, 0xFB57, 0xFB58, 0xFB59),  # peh
    "چ": (0xFB7A, 0xFB7B, 0xFB7C, 0xFB7D),  # tcheh
    "ڈ": (0xFB88, 0xFB89, None, None),    # ddal (Urdu)
    "ڑ": (0xFB8C, 0xFB8D, None, None),    # rreh (Urdu)
    "ژ": (0xFB8A, 0xFB8B, None, None),    # jeh (Farsi zhe)
    "ک": (0xFB8E, 0xFB8F, 0xFB90, 0xFB91),  # keheh (Farsi kaf)
    "گ": (0xFB92, 0xFB93, 0xFB94, 0xFB95),  # gaf
    "ں": (0xFB9E, 0xFB9F, None, None),    # noon ghunna
    "ھ": (0xFBAA, 0xFBAB, 0xFBAC, 0xFBAD),  # heh doachashmee
    "ہ": (0xFBA6, 0xFBA7, 0xFBA8, 0xFBA9),  # heh goal (Urdu)
    "ی": (0xFBFC, 0xFBFD, 0xFBFE, 0xFBFF),  # Farsi yeh
    "ے": (0xFBAE, 0xFBAF, None, None),    # yeh barree (Urdu)
    "ۓ": (0xFBB0, 0xFBB1, None, None),    # yeh barree hamza
}

# lam + alef-variant -> (isolated, final) ligature (mandatory in shaping)
_LAM_ALEF = {
    "آ": (0xFEF5, 0xFEF6),
    "أ": (0xFEF7, 0xFEF8),
    "إ": (0xFEF9, 0xFEFA),
    "ا": (0xFEFB, 0xFEFC),
}

_LAM = "ل"


def _is_transparent(c: str) -> bool:
    """Combining marks don't participate in joining decisions."""
    return unicodedata.category(c) == "Mn"


def _dual(c: str) -> bool:
    f = _FORMS.get(c)
    return f is not None and f[2] is not None


def _joins_prev(c: str) -> bool:
    """Letter connects to the PRECEDING letter (dual or right-joining)."""
    return c in _FORMS and _FORMS[c][1] is not None


def shape(
    text: str, coverage: Optional[Set[str]] = None
) -> List[Tuple[str, str]]:
    """Logical-order text -> [(base_chars, glyph)] with contextual forms.

    `coverage`: glyph chars the target font provides; forms not covered fall
    back to the base char (PIL then draws the isolated form — degraded but
    never tofu). Lam-alef pairs collapse into one ligature entry whose
    base_chars is the two-character sequence."""

    def pick(base: str, codepoint: Optional[int]) -> str:
        if codepoint is None:
            return base
        g = chr(codepoint)
        if coverage is not None and g not in coverage:
            return base
        return g

    chars = list(text)
    n = len(chars)
    out: List[Tuple[str, str]] = []
    i = 0
    # joining neighbor lookup that skips transparent marks
    def prev_joins(idx: int) -> bool:
        j = idx - 1
        while j >= 0 and _is_transparent(chars[j]):
            j -= 1
        return j >= 0 and _dual(chars[j])

    def next_joins(idx: int) -> bool:
        j = idx + 1
        while j < n and _is_transparent(chars[j]):
            j += 1
        return j < n and _joins_prev(chars[j])

    while i < n:
        c = chars[i]
        if c == _LAM and i + 1 < n and chars[i + 1] in _LAM_ALEF:
            iso, fin = _LAM_ALEF[chars[i + 1]]
            form = fin if prev_joins(i) else iso
            out.append((c + chars[i + 1], pick(c + chars[i + 1], form)))
            i += 2
            continue
        if c not in _FORMS:
            out.append((c, c))
            i += 1
            continue
        iso, fin, ini, med = _FORMS[c]
        linked_prev = prev_joins(i) and fin is not None
        linked_next = next_joins(i) and ini is not None
        if linked_prev and linked_next:
            cp = med
        elif linked_prev:
            cp = fin
        elif linked_next:
            cp = ini
        else:
            cp = iso
        out.append((c, pick(c, cp)))
        i += 1
    return out


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


def render_forms(
    text: str, coverage: Optional[Set[str]] = None
) -> Tuple[str, str]:
    """(visual_glyph_string, visual_base_label) for a logical-order line.

    The glyph string is what PIL should draw left-to-right; the label is the
    same visual order but in base characters — the CTC target (the engine
    restores logical order with `visual_to_logical`)."""
    pairs = shape(text, coverage)
    glyphs = _reverse_keep_digit_runs([g for _, g in pairs])
    # base entries may be 2 chars (lam-alef); reverse WITHIN the entry too so
    # character order stays visual
    bases = _reverse_keep_digit_runs([b[::-1] for b, _ in pairs])
    return "".join(glyphs), "".join(bases)


def visual_to_logical(text: str) -> str:
    """Decode-side inverse of the visual label order."""
    return "".join(_reverse_keep_digit_runs(list(text)))


def is_arabic_family(family: str) -> bool:
    return family == "arabic"


# Codepoint pairs whose DejaVu glyphs are PIXEL-IDENTICAL (verified by
# bitmap comparison of isolated renders): Arabic-Indic vs Extended
# Arabic-Indic digits, heh/ae, alef-maksura/Farsi-yeh. Separate CTC classes
# for these force coin-flip errors by construction; the charset folds each
# variant onto its canonical form (Charset.aliased), and decoded text
# carries the canonical char — a normalization, not an information loss,
# since the burned-in pixels never distinguished them.
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
