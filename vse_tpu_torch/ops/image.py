"""Device image ops: det letterbox, rec crops, ink-tight box refinement
(the port of the main-path parts of ``vse_tpu/ops/image.py``).

Resampling is separable bilinear written as two matrix products against
tent-weight matrices, as in the reference. Like the reference, uint8 frames
go through bf16 products: the tent weights and the first product are
rounded to bf16 and the second product is accumulated in f32
(``models/bf16.py`` says how the port emulates that). Divisions by a
constant are multiplications by its f32 reciprocal, as XLA compiles them.
Layouts follow the reference: frames [B, H, W, 3], boxes xyxy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vse_tpu_torch.models.bf16 import fma, rb

# PP-OCR det normalization (ImageNet stats).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def recip(x) -> torch.Tensor:
    """The f32 reciprocal of an f32 constant (what XLA multiplies by)."""
    return torch.tensor(1.0) / torch.tensor(x, dtype=torch.float32)


def tent_matrix(out_n: int, in_n: int, device=None) -> torch.Tensor:
    """2-tap bilinear resampling matrix [out_n, in_n] matching
    cv2.INTER_LINEAR: src = (dst + 0.5) * (in/out) - 0.5 with the exact
    per-axis ratio, rows normalized."""
    out = np.arange(out_n, dtype=np.float64) + 0.5
    src = out * (in_n / out_n) - 0.5
    rows = np.arange(in_n, dtype=np.float64)
    w = np.clip(1.0 - np.abs(src[:, None] - rows[None, :]), 0.0, 1.0)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-9)
    return torch.as_tensor(w, dtype=torch.float32, device=device)


def letterbox_matmul(
    frames: torch.Tensor, out_h: int, out_w: int
) -> Tuple[torch.Tensor, Tuple[float, float]]:
    """Det preprocessing: uint8 [B, H, W, 3] -> normalized f32 canvas
    [B, out_h, out_w, 3] (aspect-preserving resize at the top-left, the rest
    padded with the normalized value of a black pixel), with the
    reference's bf16 roundings. Returns (canvas, (H / nh, W / nw)), the
    per-axis canvas -> frame factors."""
    B, H, W, C = frames.shape
    dev = frames.device
    scale = min(out_h / H, out_w / W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    wy = rb(tent_matrix(nh, H, dev))
    wx = rb(tent_matrix(nw, W, dev))
    x = rb(torch.einsum("bhwc,oh->bowc", rb(frames.float()), wy))
    x = torch.einsum("bowc,pw->bopc", x, wx)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    x = fma(x, recip(255.0).to(dev), -mean) * recip(IMAGENET_STD).to(dev)
    canvas = ((0.0 - mean) / std).expand(B, out_h, out_w, C).clone()
    canvas[:, :nh, :nw] = x
    return canvas, (H / nh, W / nw)


def crop_boxes_windowed(
    frames: torch.Tensor, boxes: torch.Tensor, out_h: int, out_w: int,
    window_rows: int = 288,
) -> torch.Tensor:
    """Rec crops with the PP-OCR aspect policy (scale to height ``out_h``,
    keep aspect, zero-pad right), each sampled inside a ``window_rows``-high
    band starting at the box's (clamped) ymin — the batched form of the
    reference's ``crop_axis_aligned_matmul_windowed``.

    frames [B, H, W, 3] (uint8 or float 0..255); boxes [B, K, 4] xyxy in
    frame coords -> f32 crops [B, K, out_h, out_w, 3] in 0..255. The window
    is applied as a mask on a full-height row matrix; the tent weights are
    computed in the window's local coordinates, exactly as the reference.
    uint8 frames take the reference's bf16 path (weights and the row
    product rounded to bf16); float frames stay f32."""
    B, H, W, _ = frames.shape
    dev = frames.device
    window = min(window_rows, H)
    xmin, ymin, xmax, ymax = boxes.unbind(-1)
    y_start = torch.clamp(torch.floor(ymin), 0, H - window)  # [B, K]
    ymin_l = torch.clamp(ymin - y_start, 0.0, window - 1.0)
    ymax_l = torch.clamp(ymax - y_start, 0.0, window - 1.0)
    bw = torch.clamp(xmax - xmin, min=1.0)
    bh = torch.clamp(ymax_l - ymin_l, min=1.0)
    # a tensor quotient: ``out_h / bh`` would be ``bh.reciprocal() * out_h``
    # in PyTorch, two roundings where XLA's divide has one
    scale_y = torch.full_like(bh, out_h) / bh
    target_w = torch.clamp(bw * scale_y, max=float(out_w))
    scale_x = target_w / bw
    oy = torch.arange(out_h, dtype=torch.float32, device=dev)
    ox = torch.arange(out_w, dtype=torch.float32, device=dev)
    ys = ymin_l[..., None] + oy / torch.clamp(scale_y, min=1e-6)[..., None]
    xs = xmin[..., None] + ox / torch.clamp(scale_x, min=1e-6)[..., None]
    rows = torch.arange(H, dtype=torch.float32, device=dev)
    cols = torch.arange(W, dtype=torch.float32, device=dev)
    r_local = rows - y_start[..., None]  # [B, K, H], exact integers
    in_window = (r_local >= 0) & (r_local < window)
    wy = torch.clamp(1.0 - (ys[..., :, None] - r_local[..., None, :]).abs(), 0.0, 1.0)
    wy = wy * in_window[..., None, :].float()  # [B, K, out_h, H]
    wx = torch.clamp(1.0 - (xs[..., :, None] - cols).abs(), 0.0, 1.0)
    wx = wx * (ox < target_w[..., None]).float()[..., None]  # [B, K, out_w, W]
    if frames.dtype == torch.uint8:
        wy, wx = rb(wy), rb(wx)
        mid = rb(torch.einsum("bkoh,bhwc->bkowc", wy, frames.float()))
    else:
        mid = torch.einsum("bkoh,bhwc->bkowc", wy, frames.float())
    return torch.einsum("bkowc,bkpw->bkopc", mid, wx)


def ink_rows(crops: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Vertical ink extent of rec crops [N, h, w, C] (float 0..255).

    Rows whose mean |dI/dx| clears 12% of the crop's dynamic range are ink.
    Only the contiguous inked run around the crop center counts (1-2-row
    dips bridged), so a neighbouring subtitle line reached by the
    y-expansion does not merge in. Returns (y0, y1, ok) per crop."""
    h, w = crops.shape[1], crops.shape[2]
    g = crops.sum(dim=-1) * recip(crops.shape[-1]).to(crops.device)  # [N, h, w]
    e = (g[:, :, 1:] - g[:, :, :-1]).abs().sum(dim=2) * recip(w - 1).to(crops.device)
    lo = e.min(dim=1).values
    rng = e.max(dim=1).values - lo
    mask = (e - lo[:, None]) > 0.12 * rng[:, None]
    dm = mask | torch.cat([mask[:, 1:], mask[:, -1:]], 1) \
        | torch.cat([mask[:, :1], mask[:, :-1]], 1)
    idx = torch.arange(h, device=crops.device)[None, :].expand_as(mask)
    c = h // 2
    neg = torch.full_like(idx, -1)
    big = torch.full_like(idx, h)
    y0run = torch.where((~dm) & (idx <= c), idx, neg).max(dim=1).values + 1
    y1run = torch.where((~dm) & (idx >= c), idx, big).min(dim=1).values - 1
    y0 = torch.where(mask & (idx >= y0run[:, None]), idx, big).min(dim=1).values
    y1 = torch.where(mask & (idx <= y1run[:, None]), idx, neg).max(dim=1).values
    ok = (rng > 2.0) & (y1 - y0 >= 3) & (y1 - y0 <= h - 2)
    return y0, y1, ok


def refine_boxes_ink(
    crops: torch.Tensor, boxes: torch.Tensor, margin: float, frame_h: int
) -> torch.Tensor:
    """Tighten boxes [..., 4] vertically to the ink band measured in their
    provisional crops [..., h, w, C] (row r of a crop reads frame y = ymin +
    r * bh / h): ink extent plus ``margin`` of the ink height (+1.5 px) per
    side; boxes without a measurable band pass through unchanged."""
    h = crops.shape[-3]
    flat_c = crops.reshape((-1,) + tuple(crops.shape[-3:]))
    flat_b = boxes.reshape(-1, 4)
    y0, y1, ok = ink_rows(flat_c)
    ymin, ymax = flat_b[:, 1], flat_b[:, 3]
    bh = torch.clamp(ymax - ymin, min=1.0)
    ink_h = (y1 - y0 + 1).float()
    pad = fma(ink_h, margin, 1.5)
    inv_h = recip(h).to(crops.device)
    ny0 = fma((y0.float() - pad) * bh, inv_h, ymin)
    ny1 = fma((y1.float() + 1.0 + pad) * bh, inv_h, ymin)
    ny0 = torch.clamp(ny0, 0.0, frame_h - 1.0)
    ny1 = torch.clamp(ny1, 0.0, frame_h - 1.0)
    refined = torch.stack([flat_b[:, 0], ny0, flat_b[:, 2], ny1], dim=-1)
    return torch.where(ok[:, None], refined, flat_b).reshape(boxes.shape)
