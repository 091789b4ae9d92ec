"""The comparison that decides ``correct``: what the program produced on a
clip against the plain reference's work on the same clip file.

Numbers, each the worst over the sampled clips:

- ``scan_stat_gap`` (keyframe strategy): the largest difference between
  the program's and the reference's per-frame scan statistics;
- ``span_mismatch`` (keyframe strategy): spans found by one side only;
- ``frames_unread``: frames the program meant to OCR and returned no
  result for;
- ``box_px_p75``: the 75th percentile, over the lines of either side
  inside the subtitle area (where the mix has one), of the largest corner
  difference in pixels between a line's box and the line of the other
  side that it matches (IoU >= 0.5, each line matched once), a line
  without a match counting as far off as the frame is wide: the boxes'
  edges are threshold crossings of the probability map, which a line
  split at a glyph gap on one side moves by tens of pixels on a few
  lines, so the quantile and not the mean or the largest; and a
  detector that finds a quarter of the lines or more nowhere (a frame
  of the batch left without boxes) reads the frame's width;
- ``read_nll_gap_mean``: the mean, over the lines that lie wholly inside
  the subtitle area, of the excess per time step of the CTC negative
  log-likelihood of the program's read of a box over that of the
  reference's own read, both under the reference's log-probabilities for
  that box, the least over the reference's crops of the box with the
  tightened top and bottom moved by up to one row. A box outside the area
  (a false detection on the gradient's edge above the bar) holds no text,
  its read is noise, and the area gate drops it before any cue;
- ``srt_mismatch``: cues of the program's SRT that differ from the cues
  the reference's post stages build from the program's reads.

The reference judges the program's reads by reading the same boxes
itself, as a served token is judged by the reference's logits at its
position; the boxes themselves are held against the reference's own
detections, and the spans against its own scan.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
from reference import clip as C
from reference import post as P


@dataclass
class Produced:
    """What one side produced for one clip: scan stats and spans (keyframe
    strategy), the frames it OCR'd in order with their arrays (boxes
    [K, 4] in band coordinates, det scores, valid, id lists, rec scores),
    and its SRT cues."""

    path: str
    stats: Optional[np.ndarray] = None
    spans: Optional[List[Tuple[int, int]]] = None
    frames: List[int] = field(default_factory=list)
    rows: List[tuple] = field(default_factory=list)
    cues: List[P.Cue] = field(default_factory=list)


NAMES = ("scan_stat_gap", "span_mismatch", "frames_unread", "box_px_p75", "read_nll_gap_mean",
         "srt_mismatch")


def _iou(a, b) -> float:
    ix = min(a[2], b[2]) - max(a[0], b[0])
    iy = min(a[3], b[3]) - max(a[1], b[1])
    if ix <= 0 or iy <= 0:
        return 0.0
    inter = ix * iy
    return inter / ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)


def _inside(box, area, y0: int) -> bool:
    """Whether a box (band coordinates, xyxy) lies wholly inside the area."""
    if area is None:
        return True
    x0, b0, x1, b1 = box
    return area[2] <= x0 and x1 <= area[3] and area[0] <= b0 + y0 and b1 + y0 <= area[1]


def line_gaps(row, ref_row, area, y0: int) -> List[Optional[float]]:
    """One frame's lines inside the area, of the program's valid boxes
    (``row``) and of the reference's (``ref_row``): for each, the largest
    corner difference in pixels to the line of the other side it matches,
    or None. Each program box takes the unused reference box of the
    highest IoU, if that is 0.5 or more."""
    pb = [row[0][k] for k in range(len(row[2])) if row[2][k]]
    rb = [ref_row[0][k] for k in range(len(ref_row[2])) if ref_row[2][k]]
    used, out = set(), []
    for b in pb:
        best = max(((i, _iou(b, r)) for i, r in enumerate(rb) if i not in used),
                   key=lambda t: t[1], default=(None, 0.0))
        matched = best[0] is not None and best[1] >= 0.5
        if matched:
            used.add(best[0])
        if _inside(b, area, y0) or (matched and _inside(rb[best[0]], area, y0)):
            out.append(float(np.abs(np.asarray(b) - np.asarray(rb[best[0]])).max())
                       if matched else None)
    out += [None for i, r in enumerate(rb) if i not in used and _inside(r, area, y0)]
    return out


def judge_clip(prod: Produced, ref: "C.Reference", traffic: dict, frames: np.ndarray,
               ts: Dict[int, float], fps: float, seed: int = 0,
               detail: Optional[dict] = None) -> Dict[str, float]:
    """The numbers of one clip. ``frames`` and ``ts`` are the reference's
    own decode of ``prod.path``. The OCR numbers cover at most the mix's
    ``judge_frames`` of the frames the program OCR'd, drawn from ``seed``;
    the SRT check covers them all. ``detail``, where given, receives the
    lines' corner gaps (None for a line without a match)."""
    out: Dict[str, float] = {}
    area = traffic.get("area")
    y0, y1 = C.band_rows(area, frames.shape[1])
    if traffic["strategy"] == "keyframe":
        a = area
        st, spans = ref.scan(frames[:, a[0]:a[1], a[2]:a[3]])
        n = min(len(st), len(prod.stats))
        out["scan_stat_gap"] = float(np.abs(st[:n] - prod.stats[:n]).max()) + (
            0.0 if len(st) == len(prod.stats) else float("inf"))
        out["span_mismatch"] = float(len(set(spans) ^ set(prod.spans)))
    out["frames_unread"] = float(abs(len(prod.frames) - len(prod.rows)))
    n_rows = min(len(prod.frames), len(prod.rows))
    pick = range(n_rows)
    n = traffic.get("judge_frames", 0)
    if n and n_rows > n:
        rng = np.random.default_rng([seed % (1 << 63), 11])
        pick = sorted(rng.choice(n_rows, n, replace=False))
    rows = [prod.rows[i] for i in pick]
    band = frames[[prod.frames[i] - 1 for i in pick], y0:y1]
    mine = ref.ocr(band)
    gaps = []
    for row, ref_row in zip(rows, mine):
        gaps += line_gaps(row, ref_row, area, y0)
    lines = [(j, k) for j, row in enumerate(rows) for k in range(len(row[2]))
             if row[2][k] and _inside(row[0][k], area, y0)]
    nll_gaps = ref.read_boxes(band, [(j, rows[j][0][k]) for j, k in lines],
                              [rows[j][3][k] for j, k in lines])
    if detail is not None:
        detail.setdefault("line_gaps", []).append(gaps)
    width = float(frames.shape[2])
    out["box_px_p75"] = float(np.quantile([width if g is None else g for g in gaps], 0.75,
                                          method="higher")) if gaps else 0.0
    out["read_nll_gap_mean"] = float(np.mean(nll_gaps)) if nll_gaps else 0.0
    reads_fmt = [C.frame_reads(r, ref.chars, (y0, 0)) for r in prod.rows[:n_rows]]
    cues = C.rebuild_cues(traffic["strategy"], prod.frames[:n_rows], reads_fmt, prod.spans, area,
                          ts, fps, ref.typo_map)
    out["srt_mismatch"] = float(len(set(cues) ^ set(prod.cues)))
    return out


def control_produced(ref_ctl: "C.Reference", traffic: dict, path: str, frames: np.ndarray,
                     ts: Dict[int, float], fps: float) -> Produced:
    """The control put in the program's place: what the reference computed
    in the control's precision produces for the clip."""
    prod = Produced(path)
    area = traffic.get("area")
    y0, y1 = C.band_rows(area, frames.shape[1])
    n = len(frames)
    strategy = traffic["strategy"]
    freq = P.PostParams().extract_frequency
    if strategy == "keyframe":
        prod.stats, prod.spans = ref_ctl.scan(frames[:, area[0]:area[1], area[2]:area[3]])
        prod.frames = [f for _, f in C.keyframe_samples(prod.spans, fps, freq)]
    elif strategy == "perframe":
        prod.frames = list(range(1, n + 1))
    else:
        prod.frames = list(range(1, n + 1, max(1, int(fps // freq))))
    band = frames[[f - 1 for f in prod.frames], y0:y1]
    prod.rows = ref_ctl.ocr(band)
    reads = [C.frame_reads(r, ref_ctl.chars, (y0, 0)) for r in prod.rows]
    prod.cues = C.rebuild_cues(strategy, prod.frames, reads, prod.spans, area, ts, fps,
                               ref_ctl.typo_map)
    return prod


def worst(per_clip: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst value over the clips."""
    keys = [k for k in NAMES if any(k in d for d in per_clip)]
    return {k: max(d[k] for d in per_clip if k in d) for k in keys}
