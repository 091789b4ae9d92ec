"""Training losses for the DB detector and the CRNN (the port of
``vse_tpu/train/losses.py``).

- DB: BCE on the shrink map with hard-negative mining (3 negatives a
  positive, plus 16), dice on the binarization map, L1 on the threshold
  map inside the dilated borders: ``L = Ls + 5 Lb + 10 Lt``.
- CRNN: CTC with blank 0, the mean over the batch of the per-sequence loss
  (optax's ``ctc_loss``, not divided by the label lengths).

Every count that decides which values are kept stays a tensor, so a loss
needs no host sync.

``group``: a ``torch.distributed`` process group over which the batch is
split (the data axis of ``train/steps.py``). Each loss is then that of the
global batch, as the JAX package's GSPMD step computes it: sums and counts
are all-reduced, the hard-negative sort runs over the all-gathered
negatives of the whole batch, and the means divide by the global counts.
The collectives are ``parallel/collectives.py``'s, which carry the
gradient through them; every rank computes the same loss, and each rank's
gradient is then ``world size`` times its share (``steps.py`` averages
them).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from vse_tpu_torch.parallel.collectives import global_cat, global_count, global_sum


def balanced_bce(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                 neg_ratio: float = 3.0, group=None) -> torch.Tensor:
    """BCE over the prob map with the hardest ``n_pos * neg_ratio + 16``
    negatives of the flattened batch (a descending sort). [B, H, W] each."""
    eps = 1e-6
    pred = torch.clamp(pred, eps, 1 - eps)
    bce = -(gt * torch.log(pred) + (1 - gt) * torch.log(1 - pred))
    pos = (gt > 0.5) & (mask > 0.5)
    neg = (gt <= 0.5) & (mask > 0.5)
    n_pos = global_count(pos.sum(dtype=torch.int32), group)
    n_neg_keep = torch.minimum(global_count(neg.sum(dtype=torch.int32), group),
                               (n_pos.float() * neg_ratio).to(torch.int32) + 16)
    pos_loss = global_sum(torch.where(pos, bce, torch.zeros_like(bce)).sum(), group)
    neg_losses = global_cat(torch.where(neg, bce, torch.full_like(bce, -1.0)).reshape(-1), group)
    sorted_neg = torch.sort(neg_losses, descending=True).values
    idx = torch.arange(sorted_neg.shape[0], device=pred.device)
    neg_loss = torch.where(idx < n_neg_keep, sorted_neg, torch.zeros_like(sorted_neg)).sum()
    denom = torch.clamp(n_pos + n_neg_keep, min=1).to(pred.dtype)
    return (pos_loss + neg_loss) / denom


def dice_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
              group=None) -> torch.Tensor:
    pred = pred * mask
    gt = gt * mask
    inter = global_sum(torch.sum(pred * gt), group)
    union = (global_sum(torch.sum(pred * pred), group) + global_sum(torch.sum(gt * gt), group)
             + 1e-6)
    return 1.0 - 2.0 * inter / union


def masked_l1(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
              group=None) -> torch.Tensor:
    n = torch.clamp(global_sum(mask.sum(), group), min=1.0)
    return global_sum(torch.sum(torch.abs(pred - gt) * mask), group) / n


def db_loss(prob, thresh, binary, gt_shrink, gt_shrink_mask, gt_thresh, gt_thresh_mask,
            alpha: float = 5.0, beta: float = 10.0, group=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full DB objective and its three terms."""
    ls = balanced_bce(prob, gt_shrink, gt_shrink_mask, group=group)
    lb = dice_loss(binary, gt_shrink, gt_shrink_mask, group)
    lt = masked_l1(thresh, gt_thresh, gt_thresh_mask, group)
    total = ls + alpha * lb + beta * lt
    return total, {"shrink_bce": ls, "binary_dice": lb, "thresh_l1": lt}


def ctc_rec_loss(logits: torch.Tensor, labels: torch.Tensor,
                 label_lengths: torch.Tensor, group=None) -> torch.Tensor:
    """CTC over [B, T, C] logits and [B, L] labels padded with 0: the mean
    over the (global) batch of each sequence's negative log-likelihood."""
    B, T, _ = logits.shape
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    input_lengths = torch.full((B,), T, dtype=torch.long, device=logits.device)
    per_seq = F.ctc_loss(log_probs, labels.long(), input_lengths, label_lengths.long(),
                         blank=0, reduction="none")
    if group is None:
        return per_seq.mean()
    # every rank holds an equal share of the batch (steps.place_batch)
    return global_sum(per_seq.sum(), group) / (B * dist.get_world_size(group))
