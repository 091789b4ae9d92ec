"""DB probability map -> text boxes on the device (the port of
``vse_tpu/ops/db_postprocess.py::db_postprocess`` with the pooled
component path the engine runs: pool 8, 2 sweeps).

Parity with the reference, which is a bounded algorithm and not an exact
connected-components labelling:

- labels propagate by ``num_sweeps`` sweeps of 4 segmented running-min scans
  (rows forward/backward, then columns) on the ``pool``x max-pooled binary
  map; a union-find would differ on components that need more sweeps. Each
  segmented scan is one ``cummin`` over keys offset per segment.
- the K largest pooled components are chosen as ``jax.lax.top_k`` does:
  equal areas keep the lower index (a stable descending sort; ``topk``
  promises no order).
- each winner's box, area, score and principal-axis angle come from its
  full-resolution pixels; min_area 16, box_thresh 0.6 and unclip 1.6 as
  configured.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

INF = 2 ** 30
_SEG = 2 ** 31  # > INF: keys of a later segment sort below every earlier one


def _segmented_min_scan(labels: torch.Tensor, fg: torch.Tensor, dim: int,
                        reverse: bool) -> torch.Tensor:
    """Running min of ``labels`` along ``dim`` that restarts at every
    background pixel; background labels pass through unchanged."""
    if reverse:
        labels, fg = labels.flip(dim), fg.flip(dim)
    seg = torch.cumsum((~fg).to(torch.int64), dim=dim)
    v = torch.cummin(labels - seg * _SEG, dim=dim).values + seg * _SEG
    out = torch.where(fg, v, labels)
    return out.flip(dim) if reverse else out


def connected_component_labels(binary: torch.Tensor, num_sweeps: int) -> torch.Tensor:
    """Bounded 4-connected labelling of [B, H, W] bool maps: component
    pixels carry the min linear index reached; background = INF."""
    B, H, W = binary.shape
    lin = torch.arange(H * W, device=binary.device, dtype=torch.int64).reshape(1, H, W)
    labels = torch.where(binary, lin, torch.full_like(lin, INF))
    for _ in range(num_sweeps):
        labels = _segmented_min_scan(labels, binary, 2, False)
        labels = _segmented_min_scan(labels, binary, 2, True)
        labels = _segmented_min_scan(labels, binary, 1, False)
        labels = _segmented_min_scan(labels, binary, 1, True)
    return labels


def component_boxes_pooled(
    hit: torch.Tensor, masked: torch.Tensor, pool: int, max_boxes: int,
    num_sweeps: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pooled-label, full-res-bounds component extraction for [B, H, W]
    maps. Returns (boxes [B, K, 4] xyxy, areas [B, K] int, scores [B, K],
    angles [B, K])."""
    B, H, W = hit.shape
    hp, wp = H // pool, W // pool
    Hc, Wc = hp * pool, wp * pool
    K = max_boxes
    dev = hit.device
    small = hit[:, :Hc, :Wc].reshape(B, hp, pool, wp, pool).amax(dim=(2, 4))
    labels = connected_component_labels(small, num_sweeps)
    flat = torch.where(small, labels, torch.zeros_like(labels)).reshape(B, -1)
    area_cells = torch.zeros((B, hp * wp), dtype=torch.int64, device=dev)
    area_cells.scatter_add_(1, flat, small.reshape(B, -1).to(torch.int64))
    order = torch.sort(area_cells, dim=1, descending=True, stable=True).indices
    top_idx = order[:, :K]  # [B, K]

    # winner index per pooled cell (K = none), upsampled, masked by hit
    eq = labels[:, None] == top_idx[:, :, None, None]  # [B, K, hp, wp]
    wid_p = torch.where(eq.any(dim=1), torch.argmax(eq.to(torch.uint8), dim=1),
                        torch.full((B, hp, wp), K, device=dev, dtype=torch.int64))
    wid = wid_p.repeat_interleave(pool, 1).repeat_interleave(pool, 2)
    hit_c = hit[:, :Hc, :Wc]
    masked_c = masked[:, :Hc, :Wc]
    wid = torch.where(hit_c, wid, torch.full_like(wid, K))
    onehot = F.one_hot(wid, K + 1)[..., :K].float()  # [B, Hc, Wc, K]
    xs = torch.arange(Wc, dtype=torch.float32, device=dev)
    ys = torch.arange(Hc, dtype=torch.float32, device=dev)
    row_cnt = onehot.sum(dim=2)  # [B, Hc, K]
    row_msk = (masked_c[..., None] * onehot).sum(dim=2)
    row_sx = (xs[None, None, :, None] * onehot).sum(dim=2)
    col_cnt = onehot.sum(dim=1)  # [B, Wc, K]

    n = row_cnt.sum(dim=1)  # [B, K]
    nd = torch.clamp(n, min=1.0)
    score = row_msk.sum(dim=1) / nd
    big = torch.tensor(float(2 ** 30), device=dev)
    neg = torch.tensor(-1.0, device=dev)
    yy = ys[None, :, None]
    xx = xs[None, :, None]
    rmin = torch.where(row_cnt > 0, yy, big).amin(dim=1)
    rmax = torch.where(row_cnt > 0, yy, neg).amax(dim=1)
    cmin = torch.where(col_cnt > 0, xx, big).amin(dim=1)
    cmax = torch.where(col_cnt > 0, xx, neg).amax(dim=1)
    boxes = torch.stack([cmin, rmin, cmax, rmax], dim=-1)
    # principal-axis angle from centered second moments on the marginals
    mx = row_sx.sum(dim=1) / nd
    my = (yy * row_cnt).sum(dim=1) / nd
    cxx = ((xx - mx[:, None, :]) ** 2 * col_cnt).sum(dim=1) / nd
    cyy = ((yy - my[:, None, :]) ** 2 * row_cnt).sum(dim=1) / nd
    cxy = ((yy - my[:, None, :]) * (row_sx - mx[:, None, :] * row_cnt)).sum(dim=1) / nd
    angles = 0.5 * torch.atan2(2.0 * cxy, cxx - cyy)

    areas = n.to(torch.int32)
    ok = areas > 0
    zero = torch.zeros((), device=dev)
    boxes = torch.where(ok[..., None], boxes, zero)
    return boxes, areas, torch.where(ok, score, zero), torch.where(ok, angles, zero)


def unclip_boxes(boxes: torch.Tensor, unclip_ratio: float, h: int, w: int) -> torch.Tensor:
    """Offset each side outward by delta = area * ratio / perimeter, clamped
    to the map."""
    bw = boxes[..., 2] - boxes[..., 0] + 1.0
    bh = boxes[..., 3] - boxes[..., 1] + 1.0
    delta = bw * bh * unclip_ratio / torch.clamp(2.0 * (bw + bh), min=1e-6)
    return torch.stack(
        [
            torch.clamp(boxes[..., 0] - delta, 0, w - 1),
            torch.clamp(boxes[..., 1] - delta, 0, h - 1),
            torch.clamp(boxes[..., 2] + delta, 0, w - 1),
            torch.clamp(boxes[..., 3] + delta, 0, h - 1),
        ],
        dim=-1,
    )


def db_postprocess(
    prob: torch.Tensor,
    max_boxes: int = 8,
    thresh: float = 0.3,
    box_thresh: float = 0.6,
    unclip_ratio: float = 1.6,
    min_area: int = 16,
    num_sweeps: int = 4,
    pool: int = 4,
):
    """prob [B, H, W] in [0, 1] -> (boxes [B, K, 4] xyxy, scores [B, K],
    valid [B, K] bool, angles [B, K])."""
    if pool < 2:
        raise NotImplementedError("only the pooled component path is ported")
    B, H, W = prob.shape
    hit = prob > thresh
    masked = torch.where(hit, prob, torch.zeros_like(prob))
    boxes, areas, scores, angles = component_boxes_pooled(
        hit, masked, pool, max_boxes, num_sweeps
    )
    valid = (areas >= min_area) & (scores > box_thresh)
    boxes = unclip_boxes(boxes, unclip_ratio, H, W)
    boxes = torch.where(valid[..., None], boxes, torch.zeros((), device=prob.device))
    return boxes, scores, valid, angles
