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


# --- the det resize of ``detect_batch`` (the reference's ``_resize_fn``) ---


def resize_weight_mat(in_n: int, out_n: int, device=None) -> torch.Tensor:
    """[in_n, out_n] f32 weights of ``jax.image.resize(..., "bilinear")``
    along one axis: a triangle kernel widened by the downscale factor
    (antialiased), each column normalized, as
    ``jax._src.image.scale._compute_weight_mat`` computes them in f32."""
    # the reciprocal of the scale is taken in f64, then rounded, as there
    inv_scale = torch.tensor(1.0 / (out_n / in_n), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(out_n, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_n, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_n - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def letterbox_resize(frames: torch.Tensor, out_h: int, out_w: int
                     ) -> Tuple[torch.Tensor, float]:
    """The JAX engine's det-only letterbox (``OcrEngine._resize_fn``):
    frames [B, H, W, 3] -> f32 canvas [B, out_h, out_w, 3] of 0..255 values,
    the aspect-preserving ``jax.image.resize`` bilinear resize at the top
    left and zeros elsewhere (rows contracted first, as its einsum does).
    Returns (canvas, 1 / scale)."""
    B, H, W, C = frames.shape
    dev = frames.device
    scale = min(out_h / H, out_w / W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    x = frames.float()
    x = torch.einsum("bhwc,ho->bowc", x, resize_weight_mat(H, nh, dev))
    x = torch.einsum("bowc,wp->bopc", x, resize_weight_mat(W, nw, dev))
    canvas = torch.zeros((B, out_h, out_w, C), dtype=torch.float32, device=dev)
    canvas[:, :nh, :nw] = x
    return canvas, 1.0 / scale


def normalize_det(x: torch.Tensor) -> torch.Tensor:
    """Det normalization of 0..255 values (uint8 or float) with the ImageNet
    statistics, as XLA compiles ``(x / 255 - mean) / std``."""
    dev = x.device
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    return fma(x.float(), recip(255.0).to(dev), -mean) * recip(IMAGENET_STD).to(dev)


# --- rectified crops (the engine's ``rectify`` option) ---------------------


def _sample(image: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, h: int,
            row0: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of frames ``image`` [B, H, W, C] at band-local
    coordinates ys / xs [B, K, h', w'] inside a band of ``h`` rows starting
    at ``row0`` [B, K] (``_bilinear_sample_one`` on the band). Returns
    [B, K, h', w', C]."""
    W = image.shape[2]
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    wy = torch.clamp(ys - y0.float(), 0.0, 1.0)[..., None]
    wx = torch.clamp(xs - x0.float(), 0.0, 1.0)[..., None]
    b = torch.arange(image.shape[0], device=image.device)[:, None, None, None]
    r0 = row0[..., None, None]

    def at(y, x):
        return image[b, r0 + y, x]

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def perspective_matrix(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Homographies [..., 3, 3] mapping the rectangles ``src`` [..., 4, 2]
    onto the quads ``tgt`` [..., 4, 2] (x, y): the 8x8 DLT system solved
    per quad (``_perspective_matrix`` / ``_perspective_matrix_dyn``)."""
    x, y = src[..., 0], src[..., 1]
    X, Y = tgt[..., 0], tgt[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    ra = torch.stack([x, y, one, zero, zero, zero, -x * X, -y * X], dim=-1)
    rb_ = torch.stack([zero, zero, zero, x, y, one, -x * Y, -y * Y], dim=-1)
    A = torch.stack([ra, rb_], dim=-2).reshape(src.shape[:-2] + (8, 8))
    b = torch.stack([X, Y], dim=-1).reshape(src.shape[:-2] + (8,))
    p = torch.linalg.solve(A, b)
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1).reshape(src.shape[:-2] + (3, 3))


def _grid(out_h: int, out_w: int, device) -> torch.Tensor:
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=device),
                            torch.arange(out_w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [h, w, 3]


def _map(grid: torch.Tensor, M: torch.Tensor):
    mapped = torch.einsum("hwj,...ij->...hwi", grid, M)
    den = torch.clamp(mapped[..., 2], min=1e-6)
    return mapped[..., 1] / den, mapped[..., 0] / den


def crop_and_rectify(image: torch.Tensor, quads: torch.Tensor, out_h: int,
                     out_w: int) -> torch.Tensor:
    """Perspective-rectify N quads [N, 4, 2] out of one frame [H, W, C]
    (float) into [N, out_h, out_w, C]; all-zero quads give black crops."""
    dev = image.device
    dst = torch.tensor([[0.0, 0.0], [out_w - 1.0, 0.0], [out_w - 1.0, out_h - 1.0],
                        [0.0, out_h - 1.0]], device=dev).expand(quads.shape[0], 4, 2)
    ys, xs = _map(_grid(out_h, out_w, dev), perspective_matrix(dst, quads.float()))
    row0 = torch.zeros((1, quads.shape[0]), dtype=torch.int64, device=dev)
    return _sample(image[None], ys[None], xs[None], image.shape[0], row0)[0]


def quads_from_boxes(boxes: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Oriented quads [..., 4, 2] (clockwise from top left) from xyxy
    bounding boxes [..., 4] of rotated components and their principal-axis
    angles [...]: the rotated rectangle's (w, h) recovered from
    Wbb = w|cos| + h|sin|, Hbb = w|sin| + h|cos|, clamped to the bbox where
    the inversion degenerates (|angle| near 45 degrees)."""
    x0, y0, x1, y1 = boxes.unbind(-1)
    wbb = torch.clamp(x1 - x0, min=1.0)
    hbb = torch.clamp(y1 - y0, min=1.0)
    c = torch.cos(angles).abs()
    s = torch.sin(angles).abs()
    det = c * c - s * s
    safe = det.abs() > 0.2
    den = torch.where(safe, det, torch.ones_like(det))
    w = torch.where(safe, (c * wbb - s * hbb) / den, wbb)
    h = torch.where(safe, (c * hbb - s * wbb) / den, hbb)
    diag = torch.sqrt(wbb * wbb + hbb * hbb)
    w = torch.minimum(torch.clamp(w, min=1.0), diag)
    h = torch.minimum(torch.clamp(h, min=1.0), diag)
    cx = (x0 + x1) / 2.0
    cy = (y0 + y1) / 2.0
    ca, sa = torch.cos(angles), torch.sin(angles)
    ux, uy = ca * w / 2.0, sa * w / 2.0
    vx, vy = -sa * h / 2.0, ca * h / 2.0
    return torch.stack([
        torch.stack([cx - ux - vx, cy - uy - vy], -1),
        torch.stack([cx + ux - vx, cy + uy - vy], -1),
        torch.stack([cx + ux + vx, cy + uy + vy], -1),
        torch.stack([cx - ux + vx, cy - uy + vy], -1),
    ], dim=-2)


def crop_quads_rectified_windowed(frames: torch.Tensor, quads: torch.Tensor, out_h: int,
                                  out_w: int, window_rows: int = 288) -> torch.Tensor:
    """The batched ``crop_quad_rectified_windowed``: each quad of
    ``quads`` [B, K, 4, 2] rectified out of its frame of ``frames``
    [B, H, W, C] (float 0..255) with the PP-OCR aspect policy (height
    ``out_h``, aspect kept, zero-padded right), sampled inside a
    ``window_rows``-high band from the quad's (clamped) top. Returns
    [B, K, out_h, out_w, C]."""
    H = frames.shape[1]
    dev = frames.device
    window = min(window_rows, H)
    q = quads.float()
    ymin = q[..., 1].amin(dim=-1)
    y_start = torch.clamp(torch.floor(ymin).to(torch.int64), 0, H - window)  # [B, K]
    local = torch.stack([q[..., 0], q[..., 1] - y_start[..., None].float()], dim=-1)
    qw = 0.5 * (torch.linalg.norm(local[..., 1, :] - local[..., 0, :], dim=-1)
                + torch.linalg.norm(local[..., 2, :] - local[..., 3, :], dim=-1))
    qh = 0.5 * (torch.linalg.norm(local[..., 3, :] - local[..., 0, :], dim=-1)
                + torch.linalg.norm(local[..., 2, :] - local[..., 1, :], dim=-1))
    qw = torch.clamp(qw, min=1.0)
    qh = torch.clamp(qh, min=1.0)
    target_w = torch.clamp(qw * out_h / qh, max=float(out_w))
    zero = torch.zeros_like(target_w)
    bottom = torch.full_like(target_w, out_h - 1.0)
    dst = torch.stack([torch.stack([zero, zero], -1),
                       torch.stack([target_w - 1.0, zero], -1),
                       torch.stack([target_w - 1.0, bottom], -1),
                       torch.stack([zero, bottom], -1)], dim=-2)
    grid = _grid(out_h, out_w, dev)
    ys, xs = _map(grid, perspective_matrix(dst, local))
    sampled = _sample(frames.float(), ys, xs, window, y_start)
    keep = (grid[..., 0] < target_w[..., None, None])[..., None]
    return torch.where(keep, sampled, torch.zeros((), device=dev))
