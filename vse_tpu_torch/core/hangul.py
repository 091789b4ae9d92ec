"""Programmatic Hangul (the port of ``vse_tpu/core/hangul.py``, a copy):
the jamo tables and syllable arithmetic that ``core/charset.py::JamoCharset``
decodes with, and the stroke renderer that ``train/synth.py`` draws korean
training lines with.

Programmatic Hangul rendering: jamo stroke shapes + syllable composition.

No font on this system covers Hangul (the environment is egress-free; see
README "Weights"), but Hangul is the one major script that is
ALGORITHMICALLY composable: every syllable U+AC00..D7A3 decomposes into
(initial, medial, final) jamo by pure arithmetic, the ~51 jamo are simple
geometric stroke figures, and the block-layout rules are standard. This
module renders structurally correct Hangul from hand-authored stroke
polylines — typographically plain, but the stroke structure IS the
character identity, which is what a recognizer needs.

Reference scope: the reference ships a trained `korean_rec_fast` head
(reference backend/models/V3/ dir; language routing
backend/tools/paddle_model_config.py:40-45). This renderer exists to train
the equivalent head from scratch.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Stroke = List[Tuple[float, float]]  # polyline in the unit square, y down

S_BASE = 0xAC00
N_INITIAL, N_MEDIAL, N_FINAL = 19, 21, 28

INITIALS = "ㄱㄲㄴㄷㄸㄹㅁㅂㅃㅅㅆㅇㅈㅉㅊㅋㅌㅍㅎ"
MEDIALS = "ㅏㅐㅑㅒㅓㅔㅕㅖㅗㅘㅙㅚㅛㅜㅝㅞㅟㅠㅡㅢㅣ"
FINALS = "\0ㄱㄲㄳㄴㄵㄶㄷㄹㄺㄻㄼㄽㄾㄿㅀㅁㅂㅄㅅㅆㅇㅈㅊㅋㅌㅍㅎ"

# consonant stroke figures (unit square)
_C: Dict[str, List[Stroke]] = {
    "ㄱ": [[(0.05, 0.08), (0.90, 0.08), (0.90, 0.95)]],
    "ㄴ": [[(0.10, 0.05), (0.10, 0.92), (0.95, 0.92)]],
    "ㄷ": [[(0.95, 0.08), (0.10, 0.08), (0.10, 0.92), (0.95, 0.92)]],
    "ㄹ": [[(0.05, 0.08), (0.90, 0.08), (0.90, 0.46), (0.10, 0.46),
            (0.10, 0.90), (0.95, 0.90)]],
    "ㅁ": [[(0.10, 0.08), (0.90, 0.08), (0.90, 0.92), (0.10, 0.92),
            (0.10, 0.08)]],
    "ㅂ": [[(0.12, 0.05), (0.12, 0.92)], [(0.88, 0.05), (0.88, 0.92)],
           [(0.12, 0.50), (0.88, 0.50)], [(0.12, 0.92), (0.88, 0.92)]],
    "ㅅ": [[(0.50, 0.05), (0.12, 0.95)], [(0.50, 0.05), (0.88, 0.95)]],
    "ㅇ": [],  # drawn as an ellipse
    "ㅈ": [[(0.05, 0.10), (0.95, 0.10)], [(0.50, 0.10), (0.12, 0.95)],
           [(0.50, 0.10), (0.88, 0.95)]],
    "ㅊ": [[(0.50, 0.00), (0.50, 0.14)], [(0.05, 0.22), (0.95, 0.22)],
           [(0.50, 0.22), (0.12, 0.95)], [(0.50, 0.22), (0.88, 0.95)]],
    "ㅋ": [[(0.05, 0.08), (0.90, 0.08), (0.90, 0.95)],
           [(0.05, 0.50), (0.90, 0.50)]],
    "ㅌ": [[(0.95, 0.08), (0.10, 0.08), (0.10, 0.92), (0.95, 0.92)],
           [(0.10, 0.50), (0.95, 0.50)]],
    "ㅍ": [[(0.05, 0.08), (0.95, 0.08)], [(0.05, 0.92), (0.95, 0.92)],
           [(0.32, 0.08), (0.27, 0.92)], [(0.68, 0.08), (0.73, 0.92)]],
    "ㅎ": [[(0.50, 0.00), (0.50, 0.12)], [(0.15, 0.20), (0.85, 0.20)]],
}
# circles: (cx, cy, rx, ry) per consonant needing one
_C_CIRCLE: Dict[str, Tuple[float, float, float, float]] = {
    "ㅇ": (0.50, 0.50, 0.40, 0.42),
    "ㅎ": (0.50, 0.63, 0.30, 0.32),
}

_DOUBLES = {"ㄲ": "ㄱ", "ㄸ": "ㄷ", "ㅃ": "ㅂ", "ㅆ": "ㅅ", "ㅉ": "ㅈ"}
_FINAL_COMPOUNDS = {
    "ㄳ": "ㄱㅅ", "ㄵ": "ㄴㅈ", "ㄶ": "ㄴㅎ", "ㄺ": "ㄹㄱ", "ㄻ": "ㄹㅁ",
    "ㄼ": "ㄹㅂ", "ㄽ": "ㄹㅅ", "ㄾ": "ㄹㅌ", "ㄿ": "ㄹㅍ", "ㅀ": "ㄹㅎ",
    "ㅄ": "ㅂㅅ",
}

# vertical-vowel stroke figures: stem + ticks, in the RIGHT slot
_V_VERT: Dict[str, List[Stroke]] = {
    "ㅣ": [[(0.45, 0.02), (0.45, 0.98)]],
    "ㅏ": [[(0.30, 0.02), (0.30, 0.98)], [(0.30, 0.50), (0.85, 0.50)]],
    "ㅑ": [[(0.30, 0.02), (0.30, 0.98)], [(0.30, 0.36), (0.85, 0.36)],
           [(0.30, 0.64), (0.85, 0.64)]],
    "ㅓ": [[(0.05, 0.50), (0.60, 0.50)], [(0.60, 0.02), (0.60, 0.98)]],
    "ㅕ": [[(0.05, 0.36), (0.60, 0.36)], [(0.05, 0.64), (0.60, 0.64)],
           [(0.60, 0.02), (0.60, 0.98)]],
    "ㅐ": [[(0.22, 0.02), (0.22, 0.98)], [(0.22, 0.50), (0.72, 0.50)],
           [(0.72, 0.02), (0.72, 0.98)]],
    "ㅒ": [[(0.22, 0.02), (0.22, 0.98)], [(0.22, 0.34), (0.72, 0.34)],
           [(0.22, 0.62), (0.72, 0.62)], [(0.72, 0.02), (0.72, 0.98)]],
    "ㅔ": [[(0.05, 0.50), (0.40, 0.50)], [(0.40, 0.02), (0.40, 0.98)],
           [(0.80, 0.02), (0.80, 0.98)]],
    "ㅖ": [[(0.05, 0.34), (0.40, 0.34)], [(0.05, 0.62), (0.40, 0.62)],
           [(0.40, 0.02), (0.40, 0.98)], [(0.80, 0.02), (0.80, 0.98)]],
}

# horizontal-vowel stroke figures in the BOTTOM slot
_V_HORIZ: Dict[str, List[Stroke]] = {
    "ㅡ": [[(0.02, 0.55), (0.98, 0.55)]],
    "ㅗ": [[(0.50, 0.05), (0.50, 0.60)], [(0.02, 0.60), (0.98, 0.60)]],
    "ㅛ": [[(0.35, 0.05), (0.35, 0.60)], [(0.65, 0.05), (0.65, 0.60)],
           [(0.02, 0.60), (0.98, 0.60)]],
    "ㅜ": [[(0.02, 0.35), (0.98, 0.35)], [(0.50, 0.35), (0.50, 0.95)]],
    "ㅠ": [[(0.02, 0.35), (0.98, 0.35)], [(0.35, 0.35), (0.35, 0.95)],
           [(0.65, 0.35), (0.65, 0.95)]],
}

# compound vowels: (horizontal part, vertical part)
_V_COMPOUND: Dict[str, Tuple[str, str]] = {
    "ㅘ": ("ㅗ", "ㅏ"), "ㅙ": ("ㅗ", "ㅐ"), "ㅚ": ("ㅗ", "ㅣ"),
    "ㅝ": ("ㅜ", "ㅓ"), "ㅞ": ("ㅜ", "ㅔ"), "ㅟ": ("ㅜ", "ㅣ"),
    "ㅢ": ("ㅡ", "ㅣ"),
}


def is_syllable(ch: str) -> bool:
    return S_BASE <= ord(ch) < S_BASE + N_INITIAL * N_MEDIAL * N_FINAL


def decompose(ch: str) -> Tuple[str, str, str]:
    """Syllable -> (initial, medial, final); final is '' when absent."""
    idx = ord(ch) - S_BASE
    l, rem = divmod(idx, N_MEDIAL * N_FINAL)
    v, t = divmod(rem, N_FINAL)
    return INITIALS[l], MEDIALS[v], (FINALS[t] if t else "")


def decompose_indices(ch: str) -> Tuple[int, int, int]:
    """Syllable -> (initial, medial, final) indices; final 0 = none."""
    idx = ord(ch) - S_BASE
    l, rem = divmod(idx, N_MEDIAL * N_FINAL)
    v, t = divmod(rem, N_FINAL)
    return l, v, t


def compose(l: int, v: int, t: int = 0) -> str:
    """(initial, medial, final) indices -> the composed syllable."""
    return chr(S_BASE + (l * N_MEDIAL + v) * N_FINAL + t)


Box = Tuple[float, float, float, float]  # (x0, y0, x1, y1) in unit square


def _layout(initial: str, medial: str, final: str) -> List[Tuple[str, Box]]:
    """Standard block layout: [(jamo_or_part, slot_box)]."""
    has_final = bool(final)
    out: List[Tuple[str, Box]] = []
    if medial in _V_VERT:
        # vertical vowel: initial left, vowel right
        bot = 0.62 if has_final else 1.0
        out.append((initial, (0.02, 0.02, 0.58, bot - 0.04)))
        out.append((medial, (0.58, 0.0, 1.0, bot)))
    elif medial in _V_HORIZ:
        bot = 0.66 if has_final else 1.0
        out.append((initial, (0.12, 0.02, 0.88, bot * 0.52)))
        out.append((medial, (0.0, bot * 0.50, 1.0, bot)))
    else:  # compound
        h, v = _V_COMPOUND[medial]
        bot = 0.64 if has_final else 1.0
        out.append((initial, (0.02, 0.02, 0.52, bot * 0.55)))
        out.append((h, (0.0, bot * 0.50, 0.62, bot)))
        out.append((v, (0.58, 0.0, 1.0, bot)))
    if has_final:
        out.append(("T:" + final, (0.08, bot + 0.02, 0.92, 0.98)))
    return out


def _consonant_figures(c: str) -> List[Tuple[List[Stroke], Box]]:
    """Consonant -> [(strokes, sub-box)] handling doubles/compounds."""
    if c in _DOUBLES:
        base = _DOUBLES[c]
        return [
            (_C[base], (0.0, 0.0, 0.48, 1.0)),
            (_C[base], (0.52, 0.0, 1.0, 1.0)),
        ]
    if c in _FINAL_COMPOUNDS:
        a, b = _FINAL_COMPOUNDS[c]
        return [
            (_C[a], (0.0, 0.0, 0.48, 1.0)),
            (_C[b], (0.52, 0.0, 1.0, 1.0)),
        ]
    return [(_C[c], (0.0, 0.0, 1.0, 1.0))]


def _circles_of(c: str) -> List[Tuple[Tuple[float, float, float, float], Box]]:
    if c in _DOUBLES or c in _FINAL_COMPOUNDS:
        parts = (
            [_DOUBLES[c]] * 2 if c in _DOUBLES else list(_FINAL_COMPOUNDS[c])
        )
        boxes = [(0.0, 0.0, 0.48, 1.0), (0.52, 0.0, 1.0, 1.0)]
        return [
            (_C_CIRCLE[p], b)
            for p, b in zip(parts, boxes)
            if p in _C_CIRCLE
        ]
    return [(_C_CIRCLE[c], (0.0, 0.0, 1.0, 1.0))] if c in _C_CIRCLE else []


def _map_box(inner: Box, outer: Box) -> Box:
    ox0, oy0, ox1, oy1 = outer
    w, h = ox1 - ox0, oy1 - oy0
    return (
        ox0 + inner[0] * w, oy0 + inner[1] * h,
        ox0 + inner[2] * w, oy0 + inner[3] * h,
    )


def syllable_figures(ch: str):
    """Syllable -> (polylines, ellipses) in the unit square.

    polylines: [[(x, y), ...]]; ellipses: [(x0, y0, x1, y1) bounding box].
    """
    initial, medial, final = decompose(ch)
    polylines: List[Stroke] = []
    ellipses: List[Box] = []

    def emit_consonant(c: str, slot: Box):
        for strokes, sub in _consonant_figures(c):
            box = _map_box(sub, slot)
            for st in strokes:
                polylines.append(
                    [(box[0] + px * (box[2] - box[0]),
                      box[1] + py * (box[3] - box[1])) for px, py in st]
                )
        for (cx, cy, rx, ry), sub in _circles_of(c):
            box = _map_box(sub, slot)
            w, h = box[2] - box[0], box[3] - box[1]
            ellipses.append(
                (box[0] + (cx - rx) * w, box[1] + (cy - ry) * h,
                 box[0] + (cx + rx) * w, box[1] + (cy + ry) * h)
            )

    def emit_vowel(v: str, slot: Box):
        table = _V_VERT if v in _V_VERT else _V_HORIZ
        for st in table[v]:
            polylines.append(
                [(slot[0] + px * (slot[2] - slot[0]),
                  slot[1] + py * (slot[3] - slot[1])) for px, py in st]
            )

    for item, slot in _layout(initial, medial, final):
        if item.startswith("T:"):
            emit_consonant(item[2:], slot)
        elif item in _V_VERT or item in _V_HORIZ:
            emit_vowel(item, slot)
        else:
            emit_consonant(item, slot)
    return polylines, ellipses


def draw_hangul(
    draw, xy: Tuple[int, int], ch: str, size: int,
    fill=(255, 255, 255), stroke_width: int = 0, stroke_fill=(0, 0, 0),
) -> None:
    """Draw one syllable block of `size` px at `xy` on a PIL ImageDraw."""
    x0, y0 = xy
    polylines, ellipses = syllable_figures(ch)
    lw = max(2, size // 12)
    # outline pass first (subtitle burn-in look), then the fill pass
    passes = []
    if stroke_width > 0:
        passes.append((stroke_fill, lw + 2 * stroke_width))
    passes.append((fill, lw))
    for color, width in passes:
        for pl in polylines:
            pts = [(x0 + px * size, y0 + py * size) for px, py in pl]
            draw.line(pts, fill=color, width=width, joint="curve")
        for (ex0, ey0, ex1, ey1) in ellipses:
            draw.ellipse(
                (x0 + ex0 * size, y0 + ey0 * size,
                 x0 + ex1 * size, y0 + ey1 * size),
                outline=color, width=width,
            )


def render_hangul_text(
    draw, xy: Tuple[int, int], text: str, size: int, font,
    fill=(255, 255, 255), stroke_width: int = 0, stroke_fill=(0, 0, 0),
) -> int:
    """Draw a mixed Hangul/ASCII line; returns the advance width in px.

    Hangul syllables use the stroke renderer; everything else falls back to
    the given PIL font (digits/punctuation in Korean subtitles)."""
    x, y = xy
    gap = max(1, size // 10)
    for ch in text:
        if is_syllable(ch):
            draw_hangul(draw, (x, y), ch, size, fill=fill,
                        stroke_width=stroke_width, stroke_fill=stroke_fill)
            x += size + gap
        elif ch == " ":
            x += size // 2
        else:
            draw.text((x, y), ch, font=font, fill=fill,
                      stroke_width=stroke_width, stroke_fill=stroke_fill)
            x += int(draw.textlength(ch, font=font)) + gap
    return x - xy[0]


def text_width(text: str, size: int, font, draw) -> int:
    gap = max(1, size // 10)
    w = 0
    for ch in text:
        if is_syllable(ch):
            w += size + gap
        elif ch == " ":
            w += size // 2
        else:
            w += int(draw.textlength(ch, font=font)) + gap
    return w
