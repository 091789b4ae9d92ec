"""The plain reference's host stages after OCR: the area and score gate,
the keyframe spans' split by text change, per-frame detection's span
tracker, the watermark and scene-text filters, dedup and the SRT cues.

Each follows the subtitle extractor's published rules (the reference
program's ``backend/main.py`` and ``backend/tools/subtitle_ocr.py``, as the
configuration sets them: similarity threshold 80%, drop score 75%, no
area deviation, empty keyframe cues deleted, a cue under one second padded
to one second). Cues are plain ``(start_ms, end_ms, text)`` tuples.
"""

from __future__ import annotations

import unicodedata
from collections import Counter, defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

Cue = Tuple[int, int, str]


@dataclass(frozen=True)
class PostParams:
    similarity: int = 80
    drop_score: int = 75
    deviation_rate: float = 0.0
    deviation_pixel: int = 50
    watermark_area_num: int = 5
    tolerant_x: int = 100
    tolerant_y: int = 50
    extract_frequency: int = 3


def ratio(a: str, b: str) -> float:
    """Normalized indel similarity (edit distance with substitution 2)."""
    la, lb = len(a), len(b)
    if la + lb == 0:
        return 1.0
    if la == 0 or lb == 0:
        return 0.0
    prev = list(range(lb + 1))
    for i in range(1, la + 1):
        cur = [i] + [0] * lb
        for j in range(1, lb + 1):
            cur[j] = prev[j - 1] if a[i - 1] == b[j - 1] else 1 + min(prev[j], cur[j - 1])
        prev = cur
    return (la + lb - prev[lb]) / (la + lb)


def quad_bounds(q) -> Tuple[float, float, float, float]:
    """(xmin, xmax, ymin, ymax) inside a quad's corners."""
    return (max(q[0][0], q[3][0]), min(q[1][0], q[2][0]),
            max(q[0][1], q[1][1]), min(q[2][1], q[3][1]))


class Area:
    def __init__(self, ymin, ymax, xmin, xmax):
        self.ymin, self.ymax, self.xmin, self.xmax = ymin, ymax, xmin, xmax

    def overflow(self, x0, x1, y0, y1) -> float:
        """Share of the union outside the area, over the area; inf when
        disjoint."""
        iw = min(self.xmax, x1) - max(self.xmin, x0)
        ih = min(self.ymax, y1) - max(self.ymin, y0)
        if iw <= 0 or ih <= 0:
            return float("inf")
        inter = float(iw) * float(ih)
        sa = (self.xmax - self.xmin) * (self.ymax - self.ymin)
        return (sa + max(0.0, x1 - x0) * max(0.0, y1 - y0) - inter) / sa - 1.0

    def contains(self, x0, x1, y0, y1) -> bool:
        return self.xmin <= x0 and x1 <= self.xmax and self.ymin <= y0 and y1 <= self.ymax


def gate(dt_box, rec_res, area: Optional[Area], p: PostParams):
    """[(box (xmin, xmax, ymin, ymax), text, prob)] of the lines kept: with
    an area, those that do not overflow it and score above the drop score."""
    kept = []
    for q, (text, prob) in zip(dt_box, rec_res):
        x0, x1, y0, y1 = quad_bounds(q)
        if area is not None and (area.overflow(x0, x1, y0, y1) > p.deviation_rate
                                 or prob <= p.drop_score / 100.0):
            continue
        kept.append(((int(x0), int(x1), int(y0), int(y1)), text, prob))
    return kept


def _merge_sim(a: str, b: str) -> float:
    sim = ratio(a, b)
    short, long_ = (a, b) if len(a) <= len(b) else (b, a)
    if 3 <= len(short) < 0.6 * len(long_):
        n = len(short)
        for w in (n, min(n + 2, len(long_))):
            for i in range(len(long_) - w + 1):
                sim = max(sim, ratio(short, long_[i:i + w]))
    return sim


def medoid(group):
    if len(group) == 1:
        return group[0]
    return max(group, key=lambda s: (sum(ratio(s[1], t[1]) for t in group), s[2]))


def split_groups(samples, thr: float, merge_thr: float = 0.5):
    """In-order samples (frame, text, conf, ...) -> cue groups: a new group
    when presence flips or the text falls under ``thr`` similarity to the
    group's head; then neighbours whose medoid reads agree at
    ``merge_thr`` (or one is a fragment of the other) merge back."""
    if not samples:
        return []
    groups = [[samples[0]]]
    for s in samples[1:]:
        head = groups[-1][0]
        if (s[1] == "") != (head[1] == "") or (s[1] and ratio(head[1], s[1]) < thr):
            groups.append([s])
        else:
            groups[-1].append(s)
    merged = [groups[0]]
    for g in groups[1:]:
        a, b = medoid(merged[-1])[1], medoid(g)[1]
        if a and b and _merge_sim(a, b) >= merge_thr:
            merged[-1].extend(g)
        else:
            merged.append(g)
    return merged


def dedup(records, thr_percent: int, single_frame_extends: bool):
    """records [(frame, text)] -> spans [(start, end, text)]: lines of one
    frame joined with spaces (NFKC), runs of similar lines merged, the
    longest variant kept."""
    by_frame: Dict[int, List[str]] = {}
    for f, t in records:
        by_frame.setdefault(f, []).append(t)
    recs = [(f, unicodedata.normalize("NFKC", ts[0] if len(ts) == 1
                                      else " ".join(ts).replace("\n", " ")))
            for f, ts in by_frame.items()]
    spans, i, n, thr = [], 0, len(recs), thr_percent / 100.0
    while i < n:
        head = recs[i][1].replace(" ", "")
        j = i
        while j + 1 < n and ratio(head, recs[j + 1][1].replace(" ", "")) >= thr:
            j += 1
        end = recs[j][0]
        if single_frame_extends and end == recs[i][0] and j + 1 < n:
            end = recs[j + 1][0]
        group = recs[i:j + 1]
        best = max(range(len(group)), key=lambda k: len(group[k][1].replace(" ", "")))
        spans.append((recs[i][0], end, group[best][1]))
        i = j + 1
    return spans


def keyframe_cues(spans, samples, area: Area, frame_ms: Callable[[int], float],
                  fps: float, p: PostParams) -> List[Cue]:
    """The keyframe strategy's cues. ``spans`` [(start, end)] from the
    scan; ``samples`` [(span_idx, frame, dt_box, rec_res)] in frame order:
    each span split where its sampled text changes, each group's medoid
    read recorded at its start, then dedup and the merge into the
    timeline (empty cues dropped)."""
    thr = p.similarity / 100.0
    by_span = defaultdict(list)
    for si, fn, dt_box, rec_res in samples:
        kept = gate(dt_box, rec_res, area, p)
        text = "".join(t.replace(" ", "") for _, t, _ in kept)
        conf = float(np.mean([q for _, _, q in kept])) if kept else 0.0
        by_span[si].append((fn, text, conf, kept))
    timeline, records = [], []
    ms_to_no = lambda ms: int(ms / fps)  # noqa: E731  the timeline's key
    for si, (s0, s1) in enumerate(spans):
        ss = by_span.get(si)
        if not ss:
            timeline.append((int(frame_ms(s0)), int(frame_ms(s1))))
            continue
        groups = split_groups(ss, thr)
        for gi, g in enumerate(groups):
            start = s0 if gi == 0 else g[0][0]
            end = groups[gi + 1][0][0] - 1 if gi + 1 < len(groups) else s1
            start_ms = int(frame_ms(start))
            timeline.append((start_ms, int(frame_ms(end))))
            if g[0][1]:
                records += [(ms_to_no(start_ms), t) for _, t, _ in medoid(g)[3]]
    by_start = {int(s[0]): s for s in dedup(records, p.similarity, False)}
    end_of = {ms_to_no(a): b for a, b in timeline}
    cues = []
    for a, b in timeline:
        s = by_start.get(ms_to_no(a))
        if s is not None:
            cues.append((a, end_of.get(int(s[1]), b), s[2].rstrip("\n")))
    return cues


def tracker_records(frames, area: Area, fps: float, p: PostParams):
    """Per-frame detection's span tracker over in-order frames
    [(frame, dt_box, rec_res)] -> records [(frame, text)]: a run of frames
    with text wholly in the area (absences shorter than max(2, 0.2 s)
    bridged) split into cue groups; each group's medoid read recorded at
    its first and last frame; a run of 256 reads flushes all groups but
    its last."""
    thr = p.similarity / 100.0
    grace = max(2, round(0.2 * fps))
    buf, records = [], []

    def inside(q):
        return area.contains(*quad_bounds(q))

    def emit(groups):
        for g in groups:
            if not g[0][1]:
                continue
            best = medoid(g)
            for f in ([g[0][0], g[-1][0]] if g[-1][0] != g[0][0] else [g[0][0]]):
                records.extend((f, t) for _, t, _ in gate(best[3], best[4], area, p))

    for fn, dt_box, rec_res in frames:
        if not any(inside(q) for q in dt_box):
            if buf and fn - buf[-1][0] >= grace:
                emit(split_groups(buf, thr))
                buf = []
            continue
        text = "".join(t for q, (t, _) in zip(dt_box, rec_res) if inside(q))
        kept = gate(dt_box, rec_res, area, p)
        conf = float(np.mean([q for _, _, q in kept])) if kept else 0.0
        buf.append((fn, text, conf, dt_box, rec_res))
        if len(buf) >= 256:
            groups = split_groups(buf, thr)
            if len(groups) > 1:
                emit(groups[:-1])
                buf = list(groups[-1])
    if buf:
        emit(split_groups(buf, thr))
    return records


def unite(coords, tx: int, ty: int):
    """Each coordinate replaced by the last one within the tolerances."""
    out = []
    for c in coords:
        rep = c
        for d in coords:
            if (abs(c[0] - d[0]) < tx and abs(c[1] - d[1]) < tx
                    and abs(c[2] - d[2]) < ty and abs(c[3] - d[3]) < ty):
                rep = d
        out.append(rep)
    return out


def filter_records(records, p: PostParams):
    """The watermark filter (drop a top-N coordinate whose text stays the
    same over at least 10 reads) and the scene-text filter (keep the modal
    y band, widened by the deviation). records [(frame, coord, text)]."""
    united = unite([r[1] for r in records], p.tolerant_x, p.tolerant_y)
    drop = set()
    for coord, _ in Counter(united).most_common(p.watermark_area_num):
        match = [r for r, u in zip(records, united) if u == coord]
        if len(match) >= 10 and len({r[2].strip() for r in match}) <= max(1, len(match) // 10):
            drop.add(coord)
    records = [r for r, u in zip(records, united) if u not in drop]
    if not records:
        return records
    y0, y1 = Counter((r[1][2], r[1][3]) for r in records).most_common(1)[0][0]
    lo, hi = abs(y0 - p.deviation_pixel), y1 + p.deviation_pixel
    return [r for r in records if lo <= r[1][2] and r[1][3] <= hi]


def padded_cues(records, frame_ms: Callable[[int], float], fps: float,
                p: PostParams) -> List[Cue]:
    """Dedup of per-frame records [(frame, text)], each span a cue, one
    shorter than a second padded to a second."""
    cues = []
    for s, e, text in dedup(records, p.similarity, True):
        end = frame_ms(int(s + fps)) if abs(e - s) < fps else frame_ms(e)
        cues.append((int(frame_ms(s)), int(end), text.rstrip("\n")))
    return cues


def reformat_cjk(text: str, typo_map: Dict[str, str]) -> str:
    """The word-segmentation pass on a Chinese cue: the typo table, spaces
    before CJK collapsed, a double space made a line break, the typo table
    again, then the punctuation and spacing fixes."""
    import re

    def typos(t):
        for pat, rep in typo_map.items():
            try:
                t = re.sub(re.compile(pat, re.I), rep, t)
            except re.error:
                continue
        return t

    text = typos(text)
    text = re.sub(r" +([一-龥])", r" \1", text).replace("  ", "\n")
    text = typos(text)
    for pat, rep in ((r"([^\sA-Z\-])([A-Z])", r"\1 \2"), ("  ", " "), ("。", "."),
                     (r" *([\.\?\!\,])", r"\1"), (r" *([\']) *", r"\1"), (r"\n\s*", "\n"),
                     (r"^\s*", ""), (r"([A-Za-z0-9]) (\-[A-Za-z0-9])", r"\1\2"),
                     (r"([A-Za-z0-9]) %", r"\1%"), (r"·$", "."), (r"\bDr\. *\b", "Dr."),
                     (r"[“”]", '"'), (r"，", ","), (r"([\.,\!\?])([A-Za-z0-9一-龥])", r"\1 \2")):
        text = text.replace(pat, rep) if pat in ("  ", "。") else re.sub(pat, rep, text)
    return text.replace("\n\n", "\n").strip()


def read_srt(path: str) -> List[Cue]:
    """(start_ms, end_ms, text) of an SRT file's cues."""
    import re

    with open(path, "r", encoding="utf-8") as f:
        data = f.read().lstrip("﻿")
    cues = []
    for block in re.split(r"\n\s*\n", data.strip()):
        lines = [x.rstrip("\r") for x in block.strip().split("\n")]
        k = next((i for i, x in enumerate(lines) if "-->" in x), None)
        if k is None:
            continue
        a, _, b = lines[k].partition("-->")
        ms = []
        for t in (a, b):
            h, m, rest = t.strip().split(":")
            s, milli = rest.replace(".", ",").split(",")
            ms.append(((int(h) * 60 + int(m)) * 60 + int(s)) * 1000 + int(milli))
        cues.append((ms[0], ms[1], "\n".join(lines[k + 1:])))
    return cues
