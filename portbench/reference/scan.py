"""The plain reference's keyframe scan: per-frame statistics of the
subtitle area and the text spans they imply (VideoSubFinder's cell voting,
as the configuration sets it: 4 x 8 cells, edge threshold 0.08, cell
density 0.4, a text frame above 2% text cells, spans of at least 6 frames,
a span split where the temporal difference spikes).

The gray value is ``r * .299 + g * .587 + b * .114`` of ``v / 255``, each
product and sum rounded to float32 as one fused multiply-add would round
it, so that a pixel lies on the same side of the edge threshold as in the
configuration's own arithmetic. ``gray_dtype=torch.bfloat16`` rounds the
gray to bfloat16 (the control's precision).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SEG_H, SEG_W = 4, 8
EDGE, MODERATE = 0.08, 0.4
TEXT_FRAC, MIN_LEN, CHANGE = 0.02, 6, 0.03
BATCH = 32  # frames scanned together; the first of each has no predecessor


def gray(frames: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    inv = torch.tensor(1.0 / 255.0, dtype=torch.float32)
    x = frames.float() * inv.to(frames.device)
    wr, wg, wb = (float(torch.tensor(w, dtype=torch.float32)) for w in (0.299, 0.587, 0.114))
    s = x[..., 1] * torch.tensor(wg, device=x.device)
    s = (x[..., 0].double() * wr + s.double()).float()
    g = (x[..., 2].double() * wb + s.double()).float()
    return g.to(dtype).float()


def stats(frames: torch.Tensor, gray_dtype=torch.float32) -> torch.Tensor:
    """uint8 [T, H, W, 3] -> f32 [T, 4]: mean |horizontal gradient|, share
    of cells whose edge density exceeds 0.4, mean |frame - previous|
    (the batch's first frame against itself), mean gray; means over the
    frame zero-padded to H a multiple of 8 and W of 128."""
    g = gray(frames, gray_dtype)
    T, H, W = g.shape
    mh = SEG_H * 8 // math.gcd(SEG_H, 8)
    mw = SEG_W * 128 // math.gcd(SEG_W, 128)
    Hp, Wp = H + (-H) % mh, W + (-W) % mw
    g = F.pad(g, (0, Wp - W, 0, Hp - H))
    prev = torch.cat([g[:1], g[:-1]])
    gx = (g[:, :, 1:] - g[:, :, :-1]).abs()
    gx = F.pad(gx, (1, 0))
    cells = (gx > EDGE).float().reshape(T, Hp // SEG_H, SEG_H, Wp // SEG_W, SEG_W).sum((2, 4))
    text = (cells / (SEG_H * SEG_W) > MODERATE).float().mean((1, 2))
    return torch.stack([gx.mean((1, 2)), text, (g - prev).abs().mean((1, 2)), g.mean((1, 2))], 1)


def scan(band: np.ndarray, device, gray_dtype=torch.float32) -> np.ndarray:
    """Stats of a whole clip's area [N, H, W, 3], in batches of ``BATCH``."""
    out = [stats(torch.from_numpy(band[i:i + BATCH]).to(device), gray_dtype).cpu()
           for i in range(0, len(band), BATCH)]
    return torch.cat(out).numpy()


def find_spans(st: np.ndarray, nos: np.ndarray) -> List[Tuple[int, int]]:
    """Spans (first, last frame) of consecutive text frames, split where the
    temporal difference exceeds max(0.03, 2.5 x its median); spans under
    6 frames dropped."""
    has = st[:, 1] > TEXT_FRAC
    spike = st[:, 2] > max(CHANGE, 2.5 * float(np.median(st[:, 2])) if len(st) else 0.0)
    spans, start = [], None
    for t in range(len(st)):
        if has[t]:
            if start is None:
                start = t
            elif spike[t]:
                if t - start >= MIN_LEN:
                    spans.append((int(nos[start]), int(nos[t - 1])))
                start = t
        elif start is not None:
            if t - start >= MIN_LEN:
                spans.append((int(nos[start]), int(nos[t - 1])))
            start = None
    if start is not None and len(st) - start >= MIN_LEN:
        spans.append((int(nos[start]), int(nos[len(st) - 1])))
    return spans
