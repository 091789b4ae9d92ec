"""Generic stroke-glyph rendering for scripts with no covering font.

The port's copy of ``vse_tpu/core/strokefont.py`` (the same data and drawing,
its imports the port's).

The zero-egress image ships only DejaVu/STIX (latin/cyrillic/greek/georgian
/arabic coverage); the reference nevertheless serves rec heads for thai,
devanagari, tamil and telugu (reference backend/models/V3/ dir — ta/te
heads; language routing backend/tools/paddle_model_config.py:25-45). Those
scripts are segmental — a bounded set of base letterforms plus positioned
combining signs — so, like Hangul (vse_tpu/core/hangul.py), they are
drawable from hand-authored stroke polylines: typographically plain, but
the stroke structure IS the character identity, which is what a recognizer
needs.

A script module provides:
  GLYPHS: dict char -> Glyph(polylines, ellipses) in the unit square
          (y down), sized for a nominal full-height consonant cell;
  MARKS:  dict char -> Mark(glyph, slot) for combining signs, where slot is
          'above' | 'below' | 'post' | 'pre' (pre marks render BEFORE the
          base they follow logically — e.g. thai เ, tamil ெ);
  optional LIGATURES: dict of char sequences replaced before layout;
  optional HEADLINE: y of a connecting top bar drawn across each word
          (devanagari shirorekha), None otherwise.

`compose_line` lays out a logical-order text into positioned figures;
`draw_text` rasterizes onto a PIL draw with the same stroke/outline passes
as the hangul renderer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Stroke = List[Tuple[float, float]]
Box = Tuple[float, float, float, float]


@dataclass(frozen=True)
class Glyph:
    """Stroke figure in the unit square; `width` = advance as a fraction of
    the nominal cell (marks usually 0)."""

    polylines: Tuple[Stroke, ...] = ()
    ellipses: Tuple[Box, ...] = ()  # bounding boxes of outline ellipses
    width: float = 1.0


@dataclass(frozen=True)
class Mark:
    glyph: Glyph
    slot: str  # 'above' | 'below' | 'post' | 'pre'
    # above/below marks stack: level 0 sits closest to the base
    level: int = 0


@dataclass(frozen=True)
class StrokeScript:
    name: str
    glyphs: Dict[str, Glyph]
    marks: Dict[str, Mark] = field(default_factory=dict)
    ligatures: Dict[str, str] = field(default_factory=dict)
    headline_y: Optional[float] = None  # unit-square y of the top bar
    # vertical band the BASE consonant occupies (marks go outside it)
    base_band: Tuple[float, float] = (0.22, 0.95)
    # STORAGE order of pre-rendered vowels: thai stores เแโใไ before the
    # consonant (they draw via the stray-mark path); indic scripts store
    # pre-matras AFTER the consonant and the layout reorders at draw time
    pre_stored_before: bool = True
    # frequency-realistic mark subset for text generation (the full mark
    # table includes rare/vedic signs real subtitles never stack)
    common_marks: Tuple[str, ...] = ()
    # frequency-realistic BASE subset (CJK: the high-frequency ideograph
    # core that dominates real subtitles; empty = derive from codepoints)
    core_bases: Tuple[str, ...] = ()

    def covers(self, ch: str) -> bool:
        if ch in self.glyphs or ch in self.marks:
            return True
        if ch in self.ligatures:
            ch = self.ligatures[ch]
        if len(ch) > 1:
            return all(self.covers(c) for c in ch)
        return False


def _map_pts(st: Stroke, box: Box) -> Stroke:
    x0, y0, x1, y1 = box
    return [(x0 + px * (x1 - x0), y0 + py * (y1 - y0)) for px, py in st]


def _map_box(b: Box, box: Box) -> Box:
    x0, y0, x1, y1 = box
    return (
        x0 + b[0] * (x1 - x0), y0 + b[1] * (y1 - y0),
        x0 + b[2] * (x1 - x0), y0 + b[3] * (y1 - y0),
    )


def compose_line(
    script: StrokeScript, text: str
) -> Tuple[List[Tuple[Stroke, bool]], float]:
    """Logical text -> ([(polyline_or_ellipse_box, is_ellipse)], advance).

    Coordinates are in 'cell' units: one nominal consonant cell is the unit
    square; x advances rightward. Pre-slot marks are emitted before their
    base; above/below marks centered over the base cell; post marks advance
    the pen. A headline (if any) is drawn per contiguous run of headlined
    glyphs."""
    # apply ligature rewrites
    for seq, rep in script.ligatures.items():
        text = text.replace(seq, rep)

    out: List[Tuple[object, bool]] = []
    x = 0.0
    b0, b1 = script.base_band
    run_start: Optional[float] = None
    run_end = 0.0

    def flush_headline():
        nonlocal run_start
        if script.headline_y is not None and run_start is not None \
                and run_end > run_start + 0.05:
            out.append((
                [(run_start, script.headline_y), (run_end, script.headline_y)],
                False,
            ))
        run_start = None

    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        if ch == " ":
            flush_headline()
            x += 0.55
            i += 1
            continue
        if ch in script.marks:
            # mark with no preceding base (stray): draw in its slot over an
            # empty cell
            m = script.marks[ch]
            cell = (x, 0.0, x + max(m.glyph.width, 0.6), 1.0)
            _emit_mark(script, out, m, cell)
            if m.slot in ("pre", "post"):
                x = cell[2] + 0.08
            i += 1
            continue
        if ch not in script.glyphs:
            i += 1  # uncovered char: caller filters, this is a safety net
            continue
        # gather this base's combining marks
        marks: List[Mark] = []
        j = i + 1
        while j < n and text[j] in script.marks:
            marks.append(script.marks[text[j]])
            j += 1
        pre = [m for m in marks if m.slot == "pre"]
        post = [m for m in marks if m.slot == "post"]
        above = sorted(
            (m for m in marks if m.slot == "above"), key=lambda m: m.level
        )
        below = sorted(
            (m for m in marks if m.slot == "below"), key=lambda m: m.level
        )
        for m in pre:
            w = max(m.glyph.width, 0.4)
            cell = (x, 0.0, x + w, 1.0)
            _emit_mark(script, out, m, cell, force_slot_band=(b0, b1))
            x = cell[2] + 0.06
        g = script.glyphs[ch]
        base_box = (x, b0, x + g.width, b1)
        if run_start is None:
            run_start = x - 0.02
        for st in g.polylines:
            out.append((_map_pts(st, base_box), False))
        for e in g.ellipses:
            out.append((_map_box(e, base_box), True))
        cell = (x, 0.0, x + g.width, 1.0)
        for m in above:
            _emit_mark(script, out, m, cell)
        for m in below:
            _emit_mark(script, out, m, cell)
        x += g.width + 0.08
        run_end = x - 0.04
        for m in post:
            w = max(m.glyph.width, 0.4)
            pcell = (x, 0.0, x + w, 1.0)
            _emit_mark(script, out, m, pcell, force_slot_band=(b0, b1))
            x = pcell[2] + 0.06
        i = j
    flush_headline()
    return out, x


def _emit_mark(script, out, m: Mark, cell: Box,
               force_slot_band: Optional[Tuple[float, float]] = None):
    b0, b1 = script.base_band
    x0, _, x1, _ = cell
    if force_slot_band is not None or m.slot in ("pre", "post"):
        band = force_slot_band or (b0, b1)
        box = (x0, band[0], x1, band[1])
    elif m.slot == "above":
        h = b0 * 0.8
        top = max(0.0, b0 - (m.level + 1) * h)
        box = (x0 + 0.15 * (x1 - x0), top, x1 - 0.15 * (x1 - x0), top + h)
    else:  # below
        h = (1.0 - b1) * 0.9
        top = b1 + 0.02 + m.level * h
        box = (x0 + 0.2 * (x1 - x0), top, x1 - 0.2 * (x1 - x0), top + h)
    for st in m.glyph.polylines:
        out.append((_map_pts(st, box), False))
    for e in m.glyph.ellipses:
        out.append((_map_box(e, box), True))


def stroke_script_for(family: str) -> Optional[StrokeScript]:
    """Registry of hand-authored stroke scripts by charset family (lazy
    imports — each data module is a few hundred glyph definitions)."""
    if family == "th":
        from vse_tpu_torch.core.thai import THAI

        return THAI
    if family == "devanagari":
        from vse_tpu_torch.core.devanagari import DEVANAGARI

        return DEVANAGARI
    if family == "ta":
        from vse_tpu_torch.core.tamil import TAMIL

        return TAMIL
    if family == "te":
        from vse_tpu_torch.core.telugu import TELUGU

        return TELUGU
    if family in ("ch", "chinese_cht", "japan"):
        from vse_tpu_torch.core.cjk import cjk_script_for

        return cjk_script_for(family)
    return None


def line_width(script: StrokeScript, text: str, size: int) -> int:
    _, adv = compose_line(script, text)
    return int(adv * size)


def draw_text(
    draw, xy: Tuple[int, int], text: str, size: int, script: StrokeScript,
    fill=(255, 255, 255), stroke_width: int = 0, stroke_fill=(0, 0, 0),
) -> int:
    """Rasterize a composed line at `size` px cell height; returns advance
    px. Same outline-then-fill passes as the hangul renderer (subtitle
    burn-in look)."""
    x0, y0 = xy
    figures, adv = compose_line(script, text)
    lw = max(2, size // 12)
    passes = []
    if stroke_width > 0:
        passes.append((stroke_fill, lw + 2 * stroke_width))
    passes.append((fill, lw))
    for color, width in passes:
        for fig, is_ellipse in figures:
            if is_ellipse:
                ex0, ey0, ex1, ey1 = fig
                draw.ellipse(
                    (x0 + ex0 * size, y0 + ey0 * size,
                     x0 + ex1 * size, y0 + ey1 * size),
                    outline=color, width=width,
                )
            else:
                pts = [(x0 + px * size, y0 + py * size) for px, py in fig]
                if len(pts) >= 2:
                    draw.line(pts, fill=color, width=width, joint="curve")
    return int(adv * size)
