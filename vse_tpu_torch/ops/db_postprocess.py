"""DB probability map -> text boxes on the device (the port of
``vse_tpu/ops/db_postprocess.py``: ``db_postprocess`` with the pooled
component path the engine runs by default, pool 8 and 2 sweeps, and the
unpooled full-resolution path, ``db_pool`` 1, of ``component_boxes``;
``box_mean_scores``; and the host reference ``db_postprocess_host``).

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
  configured. Unpooled, the components are labelled at full resolution and
  each winner's stats are masked reductions over its own pixels, as
  ``component_boxes`` does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
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


def component_boxes(
    binary: torch.Tensor, max_boxes: int, num_sweeps: int = 4,
    pixel_prob_sum: torch.Tensor = None, pixel_prob_cnt: torch.Tensor = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Up to ``max_boxes`` component boxes of [B, H, W] bool maps, labelled
    at full resolution, largest first. With ``pixel_prob_sum`` / ``_cnt``
    [B, H, W], a component's score is the mean probability over its own
    pixels, else 0. Returns (boxes [B, K, 4] xyxy, areas [B, K] int, scores
    [B, K], angles [B, K], the principal-axis angle of each component)."""
    B, H, W = binary.shape
    dev = binary.device
    labels = connected_component_labels(binary, num_sweeps)
    flat = torch.where(binary, labels, torch.zeros_like(labels)).reshape(B, -1)
    area = torch.zeros((B, H * W), dtype=torch.int64, device=dev)
    area.scatter_add_(1, flat, binary.reshape(B, -1).to(torch.int64))
    top_area, top_idx = torch.sort(area, dim=1, descending=True, stable=True)
    top_area, top_idx = top_area[:, :max_boxes], top_idx[:, :max_boxes]
    rows = torch.arange(H, device=dev, dtype=torch.int64)[:, None].expand(H, W)
    cols = torch.arange(W, device=dev, dtype=torch.int64)[None, :].expand(H, W)
    fy, fx = rows.float(), cols.float()
    big = torch.tensor(2 ** 30, device=dev)
    neg = torch.tensor(-1, device=dev)
    zero = torch.zeros((), device=dev)
    boxes, scores, angles = [], [], []
    for k in range(max_boxes):
        mask = labels == top_idx[:, k, None, None]  # [B, H, W]
        rmin = torch.where(mask, rows, big).amin(dim=(1, 2))
        rmax = torch.where(mask, rows, neg).amax(dim=(1, 2))
        cmin = torch.where(mask, cols, big).amin(dim=(1, 2))
        cmax = torch.where(mask, cols, neg).amax(dim=(1, 2))
        boxes.append(torch.stack([cmin, rmin, cmax, rmax], dim=-1).float())
        if pixel_prob_sum is not None:
            psum = torch.where(mask, pixel_prob_sum, zero).sum(dim=(1, 2))
            pcnt = torch.where(mask, pixel_prob_cnt, zero).sum(dim=(1, 2))
            scores.append(psum / torch.clamp(pcnt, min=1.0))
        else:
            scores.append(torch.zeros((B,), device=dev))
        mf = mask.float()
        n = torch.clamp(mf.sum(dim=(1, 2)), min=1.0)
        mx = (mf * fx).sum(dim=(1, 2)) / n
        my = (mf * fy).sum(dim=(1, 2)) / n
        dx = fx - mx[:, None, None]
        dy = fy - my[:, None, None]
        cxx = (mf * dx ** 2).sum(dim=(1, 2)) / n
        cyy = (mf * dy ** 2).sum(dim=(1, 2)) / n
        cxy = (mf * dx * dy).sum(dim=(1, 2)) / n
        angles.append(0.5 * torch.atan2(2.0 * cxy, cxx - cyy))
    ok = top_area > 0
    boxes = torch.where(ok[..., None], torch.stack(boxes, 1), zero)
    scores = torch.where(ok, torch.stack(scores, 1), zero)
    angles = torch.where(ok, torch.stack(angles, 1), zero)
    return boxes, top_area.to(torch.int32), scores, angles


def box_mean_scores(prob: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Mean probability inside each inclusive (xmin, ymin, xmax, ymax) box
    through a 2-D integral image. prob [H, W], boxes [K, 4] -> [K]."""
    ii = torch.nn.functional.pad(torch.cumsum(torch.cumsum(prob, 0), 1), (1, 0, 1, 0))
    x0 = boxes[:, 0].to(torch.int64)
    y0 = boxes[:, 1].to(torch.int64)
    x1 = boxes[:, 2].to(torch.int64) + 1
    y1 = boxes[:, 3].to(torch.int64) + 1
    total = ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]
    npix = torch.clamp((x1 - x0) * (y1 - y0), min=1).to(prob.dtype)
    return total / npix


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
    valid [B, K] bool, angles [B, K]). ``pool`` > 1 labels components on
    the max-pooled map; 1 labels them at full resolution."""
    B, H, W = prob.shape
    hit = prob > thresh
    masked = torch.where(hit, prob, torch.zeros_like(prob))
    if pool > 1:
        boxes, areas, scores, angles = component_boxes_pooled(
            hit, masked, pool, max_boxes, num_sweeps
        )
    else:
        boxes, areas, scores, angles = component_boxes(
            hit, max_boxes, num_sweeps, pixel_prob_sum=masked,
            pixel_prob_cnt=hit.float(),
        )
    valid = (areas >= min_area) & (scores > box_thresh)
    boxes = unclip_boxes(boxes, unclip_ratio, H, W)
    boxes = torch.where(valid[..., None], boxes, torch.zeros((), device=prob.device))
    return boxes, scores, valid, angles


def db_postprocess_host(
    prob: np.ndarray,
    max_boxes: int = 8,
    thresh: float = 0.3,
    box_thresh: float = 0.6,
    unclip_ratio: float = 1.6,
    min_area: int = 16,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy/scipy reference of ``db_postprocess`` for one [H, W] map,
    with exact connected components (the reference's verification twin)."""
    from scipy import ndimage

    H, W = prob.shape
    binary = prob > thresh
    labels, n = ndimage.label(binary)
    boxes, scores, areas = [], [], []
    for comp in range(1, n + 1):
        ys, xs = np.nonzero(labels == comp)
        boxes.append([xs.min(), ys.min(), xs.max(), ys.max()])
        # the mean probability over the component's own pixels
        scores.append(float(prob[ys, xs].mean()))
        areas.append(len(ys))
    order = np.argsort(areas)[::-1][:max_boxes]
    out_boxes = np.zeros((max_boxes, 4), np.float32)
    out_scores = np.zeros((max_boxes,), np.float32)
    out_valid = np.zeros((max_boxes,), bool)
    for k, i in enumerate(order):
        b = boxes[i]
        bw, bh = b[2] - b[0] + 1.0, b[3] - b[1] + 1.0
        delta = bw * bh * unclip_ratio / max(2 * (bw + bh), 1e-6)
        out_boxes[k] = [
            max(0, b[0] - delta),
            max(0, b[1] - delta),
            min(W - 1, b[2] + delta),
            min(H - 1, b[3] + delta),
        ]
        out_scores[k] = scores[i]
        out_valid[k] = areas[i] >= min_area and scores[i] > box_thresh
    out_boxes[~out_valid] = 0.0
    return out_boxes, out_scores, out_valid
