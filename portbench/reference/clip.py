"""The plain reference on one clip file: decode it with OpenCV, scan the
area (keyframe strategy), OCR the given frames, and rebuild the cues from
a set of per-frame reads.

``Reference`` holds the float32 models, each found by the ``kind`` of its
configuration section (``reference/arch/<kind>.py``), or, with
``control=True``, the same models in float8, the resampling products of
the letterbox and the crops in float8 and the scan's gray in bfloat16: the
control that the comparison has to fail. It imports nothing of the
program: the clip files, the weight files and the charset file are read
here.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import arch
from . import models as M
from . import ocr as O
from . import post as P
from . import scan as S

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def decode(path: str) -> Tuple[np.ndarray, Dict[int, float], float]:
    """RGB frames [N, H, W, 3], each frame's timestamp (ms, by 1-based frame
    number, as the decoder reports it after the read) and the fps."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(path)
    fps = float(cap.get(cv2.CAP_PROP_FPS)) or 25.0
    frames, ts = [], {}
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[:, :, ::-1])
        ts[len(frames)] = float(cap.get(cv2.CAP_PROP_POS_MSEC))
    cap.release()
    return np.stack(frames), ts, fps


class Reference:
    def __init__(self, config: dict, device, control: bool = False):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        det, rec = config["det"], config["rec"]
        path = lambda p: os.path.join(ROOT, p)  # noqa: E731
        self.det = arch.of(det).load(path(det["weights"]), det)
        self.rec = arch.of(rec).load(path(rec["weights"]), rec)
        self.control = control
        self.q = M.fp8 if control else O.same
        if control:
            M.quantize_fp8(self.det)
            M.quantize_fp8(self.rec)
        self.det.to(self.device)
        self.rec.to(self.device)
        self.chars = O.load_chars(path(rec["dict"]))
        with open(path(config["post"]["typo_map"]), "r", encoding="utf-8") as f:
            self.typo_map = json.load(f)
        self.params = O.OcrParams(rec_h=rec["image_height"], rec_w=rec["image_width"])

    def scan(self, band: np.ndarray):
        gd = torch.bfloat16 if self.control else torch.float32
        st = S.scan(band, self.device, gd)
        return st, S.find_spans(st, np.arange(1, len(st) + 1))

    def ocr(self, frames: np.ndarray, chunk: int = 8):
        """OCR of frames [B, h, w, 3]: per frame (boxes, det scores, valid,
        ids, rec scores)."""
        out = []
        for i in range(0, len(frames), chunk):
            x = torch.from_numpy(np.ascontiguousarray(frames[i:i + chunk])).to(self.device)
            b, d, v, ids, r = O.ocr_arrays(x, self.det, self.rec, self.params, self.q)
            out += [(b[j], d[j], v[j], ids[j], r[j]) for j in range(len(x))]
        return out

    # the tightened crop's top and bottom moved by up to one provisional row:
    # the ink band's edge rows are threshold decisions that a precision
    # below f32 (the program's bf16 crops) legitimately flips
    SHIFTS = tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1))

    def read_boxes(self, frames: np.ndarray, pairs: Sequence[Tuple[int, np.ndarray]],
                   ids: Sequence[Sequence[int]], chunk: int = 8) -> List[float]:
        """The reference's judgement of reads of boxes: ``pairs`` (index into
        ``frames``, xyxy box in band coordinates) read as ``ids``. For each,
        the least over ``SHIFTS`` of the excess of the CTC negative
        log-likelihood a step of ``ids`` over that of its own read of the
        same crop."""
        out = []
        for i in range(0, len(pairs), chunk):
            part = pairs[i:i + chunk]
            x = torch.from_numpy(np.ascontiguousarray(frames[[j for j, _ in part]])).to(self.device)
            bx = torch.from_numpy(np.asarray([b for _, b in part], np.float32)).to(self.device)
            logp = O.rec_on_boxes(x, bx, self.rec, self.params, self.SHIFTS)
            for n in range(len(part)):
                gaps = []
                for v in range(logp.shape[1]):
                    mine, _ = O.greedy_of(logp[n, v])
                    gaps.append(ctc_nll(logp[n, v], ids[i + n]) - ctc_nll(logp[n, v], mine))
                out.append(max(0.0, min(gaps)))
        return out


def ctc_nll(logp: torch.Tensor, ids: Sequence[int]) -> float:
    """CTC negative log-likelihood a time step of the labels ``ids`` (blank
    0) under log-probabilities [T, C]."""
    T = logp.shape[0]
    if len(ids) > T:
        return float("inf")
    nll = torch.nn.functional.ctc_loss(
        logp[:, None], torch.tensor(list(ids), dtype=torch.long, device=logp.device),
        (T,), (len(ids),), blank=0, reduction="sum", zero_infinity=False)
    return float(nll) / T


def band_rows(area: Optional[Sequence[int]], height: int, margin: int = 50) -> Tuple[int, int]:
    """Rows that the OCR reads: the area plus ``max(32, margin)`` above and
    below, or the whole frame without an area."""
    if area is None:
        return 0, height
    m = max(32, margin)
    y0, y1 = max(0, area[0] - m), min(height, area[1] + m)
    return (0, height) if y1 - y0 >= height else (y0, y1)


def keyframe_samples(spans, fps: float, freq: int) -> List[Tuple[int, int]]:
    """(span index, frame) of each span's OCR sample, ``fps // freq`` apart."""
    stride = max(1, int(fps // freq))
    return [(si, f) for si, (a, b) in enumerate(spans) for f in range(a, b + 1, stride)]


def frame_reads(ocr_row, chars, origin) -> tuple:
    """(dt_box, rec_res) of one frame's arrays (boxes in band coords)."""
    boxes, _, valid, ids, scores = ocr_row
    return O.format_frame(boxes, valid, ids, scores, chars, origin)


def rebuild_cues(strategy: str, frame_nos: Sequence[int], reads: Sequence[tuple],
                 spans, area, ts: Dict[int, float], fps: float, typo_map: dict,
                 p: P.PostParams = P.PostParams()) -> List[P.Cue]:
    """The cues that the reads of ``frame_nos`` (in order, each a
    ``(dt_box, rec_res)``) give under the strategy, each cue's text through
    the word-segmentation pass."""
    return [(a, b, P.reformat_cjk(t, typo_map) if t and len(t) <= 1000 else t)
            for a, b, t in _cues(strategy, frame_nos, reads, spans, area, ts, fps, p)]


def _cues(strategy, frame_nos, reads, spans, area, ts, fps, p) -> List[P.Cue]:
    frame_ms = lambda n: ts[n] if n in ts else float(int(n / fps * 1000.0))  # noqa: E731
    ar = P.Area(*area) if area is not None else None
    if strategy == "keyframe":
        span_of = {f: si for si, f in keyframe_samples(spans, fps, p.extract_frequency)}
        samples = [(span_of[f], f, d, r) for f, (d, r) in zip(frame_nos, reads)]
        return P.keyframe_cues(spans, samples, ar, frame_ms, fps, p)
    if strategy == "perframe":
        recs = P.tracker_records([(f, d, r) for f, (d, r) in zip(frame_nos, reads)], ar, fps, p)
        return P.padded_cues(recs, frame_ms, fps, p)
    recs = [(f, box, t) for f, (d, r) in zip(frame_nos, reads)
            for box, t, _ in P.gate(d, r, ar, p)]
    recs = P.filter_records(recs, p)
    return P.padded_cues([(f, t) for f, _, t in recs], frame_ms, fps, p)
