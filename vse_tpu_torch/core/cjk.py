"""CJK ideograph composition for the no-font training path.

The port's copy of ``vse_tpu/core/cjk.py`` (the same data and drawing,
its imports the port's).

The zero-egress image ships no font covering CJK Unified Ideographs
(tools/probe_fonts.py: best coverage 96/21059 for `ch`), yet the reference
serves dedicated rec heads for ch / chinese_cht / japan (reference
backend/models/V3/ dir — ch_rec_fast, chinese_cht_rec_fast, japan_rec_fast;
language routing backend/tools/paddle_model_config.py:50-82). Ideographic
characters are COMPOSITIONAL: nearly every one is a spatial arrangement of
a bounded set of components (radicals/primitives), which is exactly the
structure Ideographic Description Sequences (IDS, Unicode §18.2) encode.

So the same trick that unblocked hangul (vse_tpu/core/hangul.py) and the
segmental stroke scripts (vse_tpu/core/strokefont.py) applies: hand-author
stroke glyphs for ~180 components (vse_tpu/core/cjk_components.py), record
an IDS decomposition per covered character (vse_tpu/core/cjk_ids.py), and
compose recursively at draw time. The result plugs into the existing
StrokeScript pipeline — every composed character becomes one full-width
Glyph, so `strokefont.compose_line`/`draw_text` and the synth renderer
work unchanged. Kana (for `japan`) are authored directly
(vse_tpu/core/kana.py) with voiced forms composed base+dakuten.

Layout operators implemented (leaf boxes in the unit square, y down):
  ⿰ left-right      ⿱ top-bottom     ⿲ three across    ⿳ three down
  ⿴ full surround   ⿵ surround-from-above   ⿶ surround-from-below
  ⿷ surround-from-left  ⿸ top-left surround  ⿹ top-right surround
  ⿺ bottom-left surround  ⿻ overlay
Bound radical forms (氵亻扌… / 艹宀…) get narrower/shorter boxes so 清,
花 etc. keep realistic proportions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from vse_tpu_torch.core.strokefont import Box, Glyph, Stroke, StrokeScript

_OPS2 = set("⿰⿱⿴⿵⿶⿷⿸⿹⿺⿻")
_OPS3 = set("⿲⿳")

# components that render narrow when used as a LEFT piece of ⿰ (the classic
# bound radical forms) — fraction of the cell width they occupy
_NARROW_LEFT = {
    "氵": 0.30, "亻": 0.28, "彳": 0.30, "扌": 0.30, "忄": 0.30, "讠": 0.28,
    "纟": 0.32, "钅": 0.34, "饣": 0.32, "犭": 0.32, "冫": 0.26, "刂": 0.24,
    "衤": 0.34, "礻": 0.34, "阝": 0.28, "口": 0.36, "日": 0.36,
    "月": 0.38, "弓": 0.34, "山": 0.36, "土": 0.36, "女": 0.40, "王": 0.38,
    "木": 0.40, "火": 0.40, "目": 0.36, "石": 0.40, "虫": 0.40, "米": 0.42,
    "禾": 0.42, "车": 0.38, "马": 0.40, "足": 0.40, "金": 0.42, "食": 0.42,
    "糸": 0.38, "言": 0.42, "貝": 0.40, "車": 0.42, "門": 0.46, "魚": 0.44,
    "歹": 0.38, "舟": 0.40, "白": 0.38, "田": 0.40, "立": 0.38, "耳": 0.36,
    "革": 0.42, "酉": 0.40, "身": 0.38, "骨": 0.42, "豸": 0.38, "牜": 0.34,
    "片": 0.36, "方": 0.38, "欠": 0.42, "攵": 0.42, "页": 0.40, "頁": 0.42,
    "鸟": 0.42, "鳥": 0.42, "隹": 0.42, "寸": 0.38, "见": 0.40, "見": 0.40,
    "力": 0.36, "刀": 0.36, "又": 0.38, "子": 0.38, "咼": 0.44, "幸": 0.42,
}
# ...and the RIGHT pieces that stay narrow when on the right (刂 阝 攵 欠 寸
# 页 力 etc. share the table above; the right box is 1 - left's width)
_NARROW_RIGHT = {
    "刂": 0.22, "阝": 0.26, "卩": 0.28, "攵": 0.40, "欠": 0.40, "寸": 0.36,
    "页": 0.42, "頁": 0.44, "力": 0.36, "刀": 0.36, "斤": 0.40, "彡": 0.30,
    "隹": 0.44, "见": 0.40, "見": 0.42, "鸟": 0.44, "鳥": 0.46, "月": 0.36,
}
# components that render short when used as the TOP piece of ⿱
_SHORT_TOP = {
    "艹": 0.24, "宀": 0.26, "冖": 0.20, "⺮": 0.26, "雨": 0.36, "人": 0.30,
    "入": 0.30, "八": 0.26, "亠": 0.22, "爫": 0.26, "𠂉": 0.22, "小": 0.28,
    "丷": 0.20, "十": 0.30, "土": 0.32, "士": 0.32, "山": 0.30, "日": 0.34,
    "曰": 0.30, "田": 0.36, "口": 0.30, "白": 0.36, "文": 0.38, "立": 0.34,
    "木": 0.38, "林": 0.36, "一": 0.14, "不": 0.38, "石": 0.36,
    "穴": 0.30, "癶": 0.28, "止": 0.32, "龰": 0.28, "夂": 0.30,
}
# components that stay short as the BOTTOM piece of ⿱ (legs / baselines)
_SHORT_BOTTOM = {
    "灬": 0.20, "心": 0.32, "一": 0.12, "儿": 0.30, "八": 0.26, "厶": 0.26,
    "凵": 0.28, "皿": 0.28, "丷": 0.20, "大": 0.34, "小": 0.30, "十": 0.30,
    "口": 0.30, "日": 0.34, "土": 0.30, "山": 0.28, "女": 0.34, "子": 0.36,
    "寸": 0.34, "巾": 0.36, "贝": 0.36, "貝": 0.38, "刀": 0.30, "力": 0.32,
    "又": 0.30, "龰": 0.28, "止": 0.30, "手": 0.38, "衣": 0.38, "水": 0.36,
}

_PAD = 0.035  # gap between sibling boxes


class _Node:
    __slots__ = ("op", "kids")

    def __init__(self, op: Optional[str], kids):
        self.op = op
        self.kids = kids  # List[_Node] | leaf payload str


def _parse(ids: str, i: int = 0) -> Tuple[_Node, int]:
    ch = ids[i]
    if ch in _OPS2 or ch in _OPS3:
        arity = 3 if ch in _OPS3 else 2
        kids = []
        j = i + 1
        for _ in range(arity):
            node, j = _parse(ids, j)
            kids.append(node)
        return _Node(ch, kids), j
    return _Node(None, ch), i + 1


def _leaf_root(node: _Node) -> str:
    """Leading leaf char of a subtree (drives proportion heuristics)."""
    while node.op is not None:
        node = node.kids[0]
    return node.kids


def _sub_boxes(op: str, kids: List[_Node]) -> List[Box]:
    if op == "⿰":
        a = _leaf_root(kids[0])
        b = _leaf_root(kids[1])
        if b in _NARROW_RIGHT:
            wb = _NARROW_RIGHT[b]
            wa = 1.0 - wb - _PAD
        else:
            wa = _NARROW_LEFT.get(a, 0.46)
        return [(0.0, 0.0, wa, 1.0), (wa + _PAD, 0.0, 1.0, 1.0)]
    if op == "⿱":
        a = _leaf_root(kids[0])
        b = _leaf_root(kids[1])
        if b in _SHORT_BOTTOM and a not in _SHORT_TOP:
            hb = _SHORT_BOTTOM[b]
            ha = 1.0 - hb - _PAD
        else:
            ha = _SHORT_TOP.get(a, 0.46)
        return [(0.0, 0.0, 1.0, ha), (0.0, ha + _PAD, 1.0, 1.0)]
    if op == "⿲":
        return [(0.0, 0.0, 0.31, 1.0), (0.345, 0.0, 0.655, 1.0),
                (0.69, 0.0, 1.0, 1.0)]
    if op == "⿳":
        return [(0.0, 0.0, 1.0, 0.30), (0.0, 0.35, 1.0, 0.64),
                (0.0, 0.69, 1.0, 1.0)]
    if op == "⿴":
        return [(0.0, 0.0, 1.0, 1.0), (0.25, 0.26, 0.75, 0.78)]
    if op == "⿵":
        return [(0.0, 0.0, 1.0, 1.0), (0.27, 0.38, 0.73, 0.93)]
    if op == "⿶":
        return [(0.0, 0.0, 1.0, 1.0), (0.27, 0.04, 0.73, 0.60)]
    if op == "⿷":
        return [(0.0, 0.0, 1.0, 1.0), (0.32, 0.26, 0.96, 0.76)]
    if op == "⿸":
        return [(0.0, 0.0, 1.0, 1.0), (0.30, 0.44, 0.98, 1.0)]
    if op == "⿹":
        return [(0.0, 0.0, 1.0, 1.0), (0.04, 0.36, 0.66, 0.95)]
    if op == "⿺":
        return [(0.0, 0.0, 1.0, 1.0), (0.34, 0.0, 1.0, 0.58)]
    if op == "⿻":
        return [(0.0, 0.0, 1.0, 1.0), (0.0, 0.0, 1.0, 1.0)]
    raise ValueError(f"unknown IDS operator {op!r}")


def _map_stroke(st: Stroke, box: Box) -> Stroke:
    x0, y0, x1, y1 = box
    return [(x0 + px * (x1 - x0), y0 + py * (y1 - y0)) for px, py in st]


def _map_box(b: Box, box: Box) -> Box:
    x0, y0, x1, y1 = box
    return (x0 + b[0] * (x1 - x0), y0 + b[1] * (y1 - y0),
            x0 + b[2] * (x1 - x0), y0 + b[3] * (y1 - y0))


class CjkComposer:
    """char -> composed full-width Glyph, via components + IDS tables."""

    def __init__(self, components: Dict[str, Glyph], ids: Dict[str, str],
                 extra: Optional[Dict[str, Glyph]] = None):
        self.components = dict(components)
        if extra:
            self.components.update(extra)
        self.ids = ids
        self._cache: Dict[str, Glyph] = {}
        self._bad: set = set()

    def coverable(self, ch: str) -> bool:
        if ch in self._bad:
            return False
        if ch in self.components:
            return True
        ids = self.ids.get(ch)
        if ids is None:
            return False
        ok = self._ids_coverable(ids, {ch})
        if not ok:
            self._bad.add(ch)
        return ok

    def _ids_coverable(self, ids: str, seen: set) -> bool:
        for c in ids:
            if c in _OPS2 or c in _OPS3 or c in self.components:
                continue
            if c in seen:  # decomposition cycle: refuse
                return False
            sub = self.ids.get(c)
            if sub is None or not self._ids_coverable(sub, seen | {c}):
                return False
        return True

    def compose(self, ch: str) -> Glyph:
        got = self._cache.get(ch)
        if got is not None:
            return got
        polys: List[Stroke] = []
        ells: List[Box] = []
        self._emit(ch, (0.0, 0.0, 1.0, 1.0), polys, ells, 0)
        g = Glyph(tuple(polys), tuple(ells), 1.0)
        self._cache[ch] = g
        return g

    def _emit(self, ch: str, box: Box, polys, ells, depth: int):
        if depth > 8:
            raise ValueError(f"IDS nesting too deep at {ch!r}")
        comp = self.components.get(ch)
        # a char with BOTH a component glyph and an IDS draws the authored
        # glyph (it is the atomic form; the IDS is for lookup only)
        if comp is not None:
            for st in comp.polylines:
                polys.append(_map_stroke(st, box))
            for e in comp.ellipses:
                ells.append(_map_box(e, box))
            return
        ids = self.ids.get(ch)
        if ids is None:
            raise KeyError(f"no IDS/component for {ch!r}")
        node, end = _parse(ids)
        if end != len(ids):
            raise ValueError(f"trailing IDS garbage for {ch!r}: {ids!r}")
        self._emit_node(node, box, polys, ells, depth)

    def _emit_node(self, node: _Node, box: Box, polys, ells, depth: int):
        if node.op is None:
            self._emit(node.kids, box, polys, ells, depth + 1)
            return
        for kid, sub in zip(node.kids, _sub_boxes(node.op, node.kids)):
            self._emit_node(kid, _map_box(sub, box), polys, ells, depth)


class _ComposedGlyphs:
    """Lazy glyph mapping backing StrokeScript.glyphs: membership is a
    cheap coverability check; glyph construction happens on first access."""

    def __init__(self, composer: CjkComposer, direct: Dict[str, Glyph],
                 widths: Optional[Dict[str, float]] = None):
        self._c = composer
        self._direct = direct
        self._widths = widths or {}
        self._made: Dict[str, Glyph] = {}

    def __contains__(self, ch: str) -> bool:
        return ch in self._direct or self._c.coverable(ch)

    def __getitem__(self, ch: str) -> Glyph:
        g = self._made.get(ch)
        if g is not None:
            return g
        if ch in self._direct:
            g = self._direct[ch]
        elif self._c.coverable(ch):
            g = self._c.compose(ch)
            w = self._widths.get(ch)
            if w is not None and w != g.width:
                g = Glyph(g.polylines, g.ellipses, w)
        else:
            raise KeyError(ch)
        self._made[ch] = g
        return g

    def get(self, ch: str, default=None):
        try:
            return self[ch]
        except KeyError:
            return default


def _build(family: str) -> StrokeScript:
    from vse_tpu_torch.core.cjk_components import COMPONENTS, PUNCT
    from vse_tpu_torch.core.cjk_ids import CORE_CHARS, IDS, IDS_JA, IDS_TC

    ids = dict(IDS)
    if family == "japan":
        ids.update(IDS_JA)
    elif family == "chinese_cht":
        ids.update(IDS_TC)
    composer = CjkComposer(COMPONENTS, ids)
    direct: Dict[str, Glyph] = dict(PUNCT)
    if family == "japan":
        from vse_tpu_torch.core.kana import KANA

        direct.update(KANA)
    # standalone component chars are themselves covered characters, but only
    # REAL characters — bound forms (氵扌…) never appear alone in text and
    # are filtered from the charset by not being in any dict anyway
    glyphs = _ComposedGlyphs(composer, direct)
    core = "".join(c for c in CORE_CHARS if c in glyphs)
    return StrokeScript(
        name=family,
        glyphs=glyphs,  # type: ignore[arg-type]
        marks={},
        base_band=(0.04, 0.96),  # ideographs fill the em square
        core_bases=tuple(core),
    )


_CACHE: Dict[str, StrokeScript] = {}


def cjk_script_for(family: str) -> Optional[StrokeScript]:
    if family not in ("ch", "chinese_cht", "japan"):
        return None
    if family not in _CACHE:
        _CACHE[family] = _build(family)
    return _CACHE[family]
