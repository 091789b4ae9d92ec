"""The plain reference's OCR step on frames, in float32: letterbox to the
det canvas, the det, the DB postprocess (pooled components, as the
configuration sets it: pool 8, 2 label sweeps, thresh 0.3, box_thresh 0.6,
unclip 1.6, at most 8 boxes), the y-expanded ink-tight crops, the CRNN and
the greedy CTC decode, then the lines sorted as subtitles are read.

Each step is the published algorithm written plainly: bilinear resampling
by tent-weight matrices in f32, component labelling by bounded min-label
sweeps, means and arg-maxes of torch. Nothing here rounds to bfloat16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class OcrParams:
    det_h: int = 576
    det_w: int = 960
    max_boxes: int = 8
    thresh: float = 0.3
    box_thresh: float = 0.6
    unclip: float = 1.6
    pool: int = 8
    sweeps: int = 2
    min_area: int = 16
    rec_h: int = 48
    rec_w: int = 320
    expand_y: float = 0.45
    tight_margin: float = 0.07
    window_rows: int = 288


def tent(out_n: int, in_n: int, device) -> torch.Tensor:
    """[out_n, in_n] bilinear weights, half-pixel centres, rows normalized."""
    src = (np.arange(out_n) + 0.5) * (in_n / out_n) - 0.5
    w = np.clip(1.0 - np.abs(src[:, None] - np.arange(in_n)[None, :]), 0.0, 1.0)
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-9)
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def det_bucket(h: int, w: int, p: OcrParams) -> Tuple[int, int]:
    r = lambda v: -(-v // 32) * 32  # noqa: E731
    return min(r(h), r(p.det_h)), min(r(w), r(p.det_w))


def same(x: torch.Tensor) -> torch.Tensor:
    return x


def letterbox(frames: torch.Tensor, out_h: int, out_w: int, q=same):
    """uint8 [B, H, W, 3] -> normalized canvas [B, out_h, out_w, 3], the
    resized frame at the top left, black (normalized) elsewhere; and the
    canvas -> frame factors (H / nh, W / nw). ``q`` rounds each product's
    operands (the control's precision)."""
    B, H, W, C = frames.shape
    dev = frames.device
    s = min(out_h / H, out_w / W)
    nh, nw = int(round(H * s)), int(round(W * s))
    x = torch.einsum("bhwc,oh->bowc", q(frames.float()), q(tent(nh, H, dev)))
    x = torch.einsum("bowc,pw->bopc", q(x), q(tent(nw, W, dev)))
    mean = torch.tensor(MEAN, device=dev)
    std = torch.tensor(STD, device=dev)
    canvas = ((0.0 - mean) / std).expand(B, out_h, out_w, C).clone()
    canvas[:, :nh, :nw] = (x / 255.0 - mean) / std
    return canvas, (H / nh, W / nw)


def _labels(binary: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Each foreground pixel's label: the least linear index that ``sweeps``
    rounds of forward and backward running minima along rows, then
    columns, reach within its run; background 2**30."""
    B, H, W = binary.shape
    lin = torch.arange(H * W, device=binary.device).reshape(1, H, W)
    lab = torch.where(binary, lin, torch.full_like(lin, 1 << 30))

    def scan(lab, dim, rev):
        fg = binary.flip(dim) if rev else binary
        v = lab.flip(dim) if rev else lab
        seg = torch.cumsum((~fg).long(), dim)
        m = torch.cummin(v - seg * (1 << 31), dim).values + seg * (1 << 31)
        out = torch.where(fg, m, v)
        return out.flip(dim) if rev else out

    for _ in range(sweeps):
        for dim, rev in ((2, False), (2, True), (1, False), (1, True)):
            lab = scan(lab, dim, rev)
    return lab


def db_boxes(prob: torch.Tensor, p: OcrParams):
    """prob [B, H, W] -> boxes [B, K, 4] xyxy (unclipped by area * ratio /
    perimeter), scores [B, K] (mean probability over the component's
    above-threshold pixels), valid [B, K]. Components are labelled on the
    ``pool`` x max-pooled map, the K largest kept (ties: lower label first),
    and measured on their full-resolution pixels."""
    B, H, W = prob.shape
    P, K = p.pool, p.max_boxes
    hp, wp = H // P, W // P
    Hc, Wc = hp * P, wp * P
    dev = prob.device
    hit = prob > p.thresh
    small = hit[:, :Hc, :Wc].reshape(B, hp, P, wp, P).amax(dim=(2, 4))
    lab = _labels(small, p.sweeps)
    flat = torch.where(small, lab, torch.zeros_like(lab)).reshape(B, -1)
    area = torch.zeros((B, hp * wp), dtype=torch.long, device=dev)
    area.scatter_add_(1, flat, small.reshape(B, -1).long())
    top = torch.sort(area, dim=1, descending=True, stable=True).indices[:, :K]
    eq = lab[:, None] == top[:, :, None, None]  # [B, K, hp, wp]
    m = eq.repeat_interleave(P, 2).repeat_interleave(P, 3) & hit[:, None, :Hc, :Wc]
    n = m.sum(dim=(2, 3)).float()
    scores = (m * prob[:, None, :Hc, :Wc]).sum(dim=(2, 3)) / n.clamp(min=1.0)
    rows, cols = m.any(dim=3), m.any(dim=2)  # [B, K, Hc], [B, K, Wc]
    ys = torch.arange(Hc, device=dev).float()
    xs = torch.arange(Wc, device=dev).float()
    big = torch.tensor(float(1 << 30), device=dev)
    boxes = torch.stack([torch.where(cols, xs, big).amin(2), torch.where(rows, ys, big).amin(2),
                         torch.where(cols, xs, -1.0).amax(2), torch.where(rows, ys, -1.0).amax(2)], -1)
    boxes = torch.where((n > 0)[..., None], boxes, torch.zeros((), device=dev))
    scores = torch.where(n > 0, scores, torch.zeros((), device=dev))
    valid = (n >= p.min_area) & (scores > p.box_thresh)
    bw = boxes[..., 2] - boxes[..., 0] + 1.0
    bh = boxes[..., 3] - boxes[..., 1] + 1.0
    d = bw * bh * p.unclip / torch.clamp(2.0 * (bw + bh), min=1e-6)
    boxes = torch.stack([(boxes[..., 0] - d).clamp(0, W - 1), (boxes[..., 1] - d).clamp(0, H - 1),
                         (boxes[..., 2] + d).clamp(0, W - 1), (boxes[..., 3] + d).clamp(0, H - 1)], -1)
    return torch.where(valid[..., None], boxes, torch.zeros((), device=dev)), scores, valid


def crop(frames: torch.Tensor, boxes: torch.Tensor, p: OcrParams, q=same) -> torch.Tensor:
    """Crops [B, K, rec_h, rec_w, 3] (0..255) of xyxy boxes: scaled to the
    rec height, aspect kept, zero on the right, sampled bilinearly within a
    ``window_rows`` band from the box's top."""
    B, H, W, _ = frames.shape
    dev = frames.device
    win = min(p.window_rows, H)
    x0, y0, x1, y1 = boxes.unbind(-1)
    ys0 = torch.clamp(torch.floor(y0), 0, H - win)
    yl0 = torch.clamp(y0 - ys0, 0.0, win - 1.0)
    yl1 = torch.clamp(y1 - ys0, 0.0, win - 1.0)
    bw = torch.clamp(x1 - x0, min=1.0)
    bh = torch.clamp(yl1 - yl0, min=1.0)
    sy = p.rec_h / bh
    tw = torch.clamp(bw * sy, max=float(p.rec_w))
    sx = tw / bw
    oy = torch.arange(p.rec_h, dtype=torch.float32, device=dev)
    ox = torch.arange(p.rec_w, dtype=torch.float32, device=dev)
    ys = yl0[..., None] + oy / torch.clamp(sy, min=1e-6)[..., None]
    xs = x0[..., None] + ox / torch.clamp(sx, min=1e-6)[..., None]
    rl = torch.arange(H, dtype=torch.float32, device=dev) - ys0[..., None]
    wy = torch.clamp(1.0 - (ys[..., :, None] - rl[..., None, :]).abs(), 0.0, 1.0)
    wy = wy * ((rl >= 0) & (rl < win))[..., None, :].float()
    wx = torch.clamp(1.0 - (xs[..., :, None] - torch.arange(W, device=dev).float()).abs(), 0.0, 1.0)
    wx = wx * (ox < tw[..., None]).float()[..., None]
    mid = torch.einsum("bkoh,bhwc->bkowc", q(wy), q(frames.float()))
    return torch.einsum("bkowc,bkpw->bkopc", q(mid), q(wx))


def ink_tighten(crops: torch.Tensor, boxes: torch.Tensor, p: OcrParams, frame_h: int):
    """Boxes tightened vertically to the ink band of their crops: rows whose
    mean |dI/dx| clears 12% of the crop's range, the run around the centre
    (1-2-row dips bridged), plus ``tight_margin`` of the ink height and
    1.5 px a side; boxes with no clear band are kept."""
    h, w = crops.shape[-3], crops.shape[-2]
    c = crops.reshape((-1, h, w, 3))
    b = boxes.reshape(-1, 4)
    g = c.mean(dim=-1)
    e = (g[:, :, 1:] - g[:, :, :-1]).abs().mean(dim=2)
    lo = e.min(dim=1).values
    rng = e.max(dim=1).values - lo
    mask = (e - lo[:, None]) > 0.12 * rng[:, None]
    dm = mask | torch.cat([mask[:, 1:], mask[:, -1:]], 1) | torch.cat([mask[:, :1], mask[:, :-1]], 1)
    idx = torch.arange(h, device=c.device)[None, :].expand_as(mask)
    mid = h // 2
    r0 = torch.where(~dm & (idx <= mid), idx, torch.full_like(idx, -1)).max(1).values + 1
    r1 = torch.where(~dm & (idx >= mid), idx, torch.full_like(idx, h)).min(1).values - 1
    y0 = torch.where(mask & (idx >= r0[:, None]), idx, torch.full_like(idx, h)).min(1).values
    y1 = torch.where(mask & (idx <= r1[:, None]), idx, torch.full_like(idx, -1)).max(1).values
    ok = (rng > 2.0) & (y1 - y0 >= 3) & (y1 - y0 <= h - 2)
    bh = torch.clamp(b[:, 3] - b[:, 1], min=1.0)
    pad = (y1 - y0 + 1).float() * p.tight_margin + 1.5
    ny0 = torch.clamp(b[:, 1] + (y0.float() - pad) * bh / h, 0.0, frame_h - 1.0)
    ny1 = torch.clamp(b[:, 1] + (y1.float() + 1.0 + pad) * bh / h, 0.0, frame_h - 1.0)
    out = torch.stack([b[:, 0], ny0, b[:, 2], ny1], -1)
    return torch.where(ok[:, None], out, b).reshape(boxes.shape)


def greedy_ctc(logits: torch.Tensor):
    """[N, T, C] -> (list of id lists, scores [N]): the arg-max path with
    repeats and blanks (0) removed; a line's score is the mean softmax
    probability of its kept steps (1 when none is kept)."""
    prob = torch.softmax(logits.float(), dim=-1)
    best_p, best = prob.max(dim=-1)
    prev = torch.cat([torch.full_like(best[:, :1], -1), best[:, :-1]], 1)
    keep = (best != 0) & (best != prev)
    ids, scores = [], []
    for n in range(best.shape[0]):
        k = keep[n]
        ids.append(best[n][k].tolist())
        scores.append(float(best_p[n][k].mean()) if bool(k.any()) else 1.0)
    return ids, np.asarray(scores, np.float32)


@torch.no_grad()
def ocr_arrays(frames: torch.Tensor, det, rec, p: OcrParams, q=same):
    """The OCR step on uint8 frames [B, h, w, 3] (on the models' device) ->
    host arrays (boxes [B, K, 4] frame coords, det scores [B, K], valid
    [B, K], ids [B][K] lists, rec scores [B, K])."""
    B, h, w, _ = frames.shape
    hd, wd = det_bucket(h, w, p)
    canvas, (fy, fx) = letterbox(frames, hd, wd, q)
    boxes, det_scores, valid = db_boxes(det(canvas), p)
    boxes = torch.stack([(boxes[..., 0] * fx).clamp(0, w - 1), (boxes[..., 1] * fy).clamp(0, h - 1),
                         (boxes[..., 2] * fx).clamp(0, w - 1), (boxes[..., 3] * fy).clamp(0, h - 1)], -1)
    bh = boxes[..., 3] - boxes[..., 1]
    cb = torch.stack([boxes[..., 0], (boxes[..., 1] - bh * p.expand_y).clamp(0, h - 1),
                      boxes[..., 2], (boxes[..., 3] + bh * p.expand_y).clamp(0, h - 1)], -1)
    cb = ink_tighten(crop(frames, cb, p, q), cb, p, h)
    crops = crop(frames, cb, p, q)
    K = crops.shape[1]
    x = (crops.reshape((B * K,) + tuple(crops.shape[2:])) / 255.0 - 0.5) / 0.5
    ids, rec_scores = greedy_ctc(rec(x))
    return (boxes.cpu().numpy(), det_scores.cpu().numpy(), valid.cpu().numpy(),
            [ids[b * K:(b + 1) * K] for b in range(B)], rec_scores.reshape(B, K))


def y_round(y: int) -> int:
    up, down = y + 10 - y % 10, y - y % 10
    return up if abs(y - up) < abs(y - down) else down


def sort_lines(coords: List[tuple], items: List) -> Tuple[List[tuple], List]:
    """Boxes (xmin, xmax, ymin, ymax) grouped into lines by ymin rounded to
    10 px, ordered top to bottom, then left to right; each box's ymin
    snapped to its line's."""
    lines: List[int] = []
    for c in coords:
        ry = y_round(c[2])
        if not lines or (ry not in lines and ry + 10 not in lines and ry - 10 not in lines):
            lines.append(ry)
    lines.sort()
    snapped = []
    for c in coords:
        ry = y_round(c[2])
        best = next((ln for ln in lines if abs(ln - ry) <= 10), c[2])
        snapped.append((c[0], c[1], best, c[3]))
    order = sorted(range(len(coords)), key=lambda i: (snapped[i][2], snapped[i][0]))
    return [snapped[i] for i in order], [items[i] for i in order]


def format_frame(boxes, valid, ids, rec_scores, chars: List[str], origin=(0, 0)):
    """One frame's lines as (dt_box quads, [(text, score)]), sorted."""
    dy, dx = origin
    coords, items = [], []
    for k in range(len(valid)):
        if not valid[k]:
            continue
        x0, y0, x1, y1 = boxes[k]
        coords.append((int(x0 + dx), int(x1 + dx), int(y0 + dy), int(y1 + dy)))
        items.append(("".join(chars[i - 1] for i in ids[k] if 1 <= i <= len(chars)),
                      float(rec_scores[k])))
    coords, items = sort_lines(coords, items)
    return [[(c[0], c[2]), (c[1], c[2]), (c[1], c[3]), (c[0], c[3])] for c in coords], items


def load_chars(path: str) -> List[str]:
    """A PaddleOCR dict (one character a line), without the space class."""
    with open(path, "r", encoding="utf-8") as f:
        return [c for c in (line.rstrip("\n").rstrip("\r") for line in f) if c and c != " "]


@torch.no_grad()
def rec_on_boxes(frames: torch.Tensor, boxes: torch.Tensor, rec, p: OcrParams,
                 shifts=((0, 0),)):
    """The reference's reads of given xyxy boxes [N, 4], one a frame of
    ``frames`` [N, h, w, 3]: each box y-expanded and ink-tightened as the
    OCR step does, then cropped once for each ``(dy0, dy1)`` of ``shifts``,
    which move the tightened top and bottom by that many rows of the
    provisional crop. Returns the log-probabilities [N, V, T, C] of the
    CRNN on the V crops of each box (on the models' device)."""
    N, h = frames.shape[0], frames.shape[1]
    bh = boxes[:, 3] - boxes[:, 1]
    cb = torch.stack([boxes[:, 0], (boxes[:, 1] - bh * p.expand_y).clamp(0, h - 1),
                      boxes[:, 2], (boxes[:, 3] + bh * p.expand_y).clamp(0, h - 1)], -1)[:, None]
    row = ((cb[..., 3] - cb[..., 1]).clamp(min=1.0) / p.rec_h)[..., None]  # [N, 1, 1]
    cb = ink_tighten(crop(frames, cb, p), cb, p, h)
    d = torch.tensor(shifts, dtype=torch.float32, device=frames.device)[None]  # [1, V, 2]
    var = torch.stack([cb[..., 0].expand(-1, d.shape[1]),
                       (cb[..., 1] + d[..., 0] * row[..., 0]).clamp(0, h - 1),
                       cb[..., 2].expand(-1, d.shape[1]),
                       (cb[..., 3] + d[..., 1] * row[..., 0]).clamp(0, h - 1)], -1)
    crops = crop(frames, var, p)
    V = crops.shape[1]
    logits = rec((crops.reshape((N * V,) + tuple(crops.shape[2:])) / 255.0 - 0.5) / 0.5)
    logp = torch.log_softmax(logits.float(), -1)
    return logp.reshape((N, V) + tuple(logp.shape[1:]))


def greedy_of(logp: torch.Tensor):
    """(ids, score) of the arg-max path of [T, C] log-probabilities."""
    ids, scores = greedy_ctc(logp[None])
    return ids[0], float(scores[0])
