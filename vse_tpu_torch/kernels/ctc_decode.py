"""Greedy CTC decode: kernel K1 and its plain PyTorch version.

The expensive part of greedy decode is the class-axis sweep over [N, T, C]
logits (C reaches ~21k for the CJK heads): ``csrc/ctc_decode.cu`` fuses the
max, first-max argmax and log-sum-exp into one read of the logits. It
replaces the Pallas kernel ``vse_tpu/kernels/ctc_decode.py::
_argmax_lse_kernel``. The collapse of repeats and blanks, the left-pack and
the mean score touch only [N, T] values and stay PyTorch ops here, as they
were plain XLA ops in the reference.

``ctc_greedy_decode`` launches the kernel for a CUDA tensor and uses the
plain version (``argmax_lse_plain``) only for a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vse_tpu_torch.kernels import _build

# launches of the CUDA kernel by ctc_greedy_decode (plain-version calls and
# direct argmax_lse_cuda calls are not counted)
launches = 0


def argmax_lse_plain(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, T, C] logits -> (best id [N, T] int32, softmax prob of best
    [N, T] f32), the first max on ties. Same arithmetic as the Pallas body."""
    x = logits.float()
    m, _ = x.max(dim=-1)
    best = torch.argmax(x, dim=-1).to(torch.int32)  # first maximal index
    lse = m + torch.log(torch.sum(torch.exp(x - m[..., None]), dim=-1))
    return best, torch.exp(m - lse)


def _threads_for(C: int) -> int:
    # one warp for small heads; up to 8 warps (4+ logits a thread) for CJK
    return int(min(256, max(32, ((C // 4) + 31) // 32 * 32)))


def argmax_lse_cuda(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on a contiguous f32 CUDA tensor [N, T, C] (not counted)."""
    if not logits.is_cuda:
        raise ValueError("argmax_lse_cuda needs a CUDA tensor")
    if logits.dtype != torch.float32:
        raise TypeError(f"K1 takes float32 logits, got {logits.dtype}")
    if logits.dim() != 3:
        raise ValueError(f"K1 takes [N, T, C] logits, got {tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("K1 takes contiguous logits")
    N, T, C = logits.shape
    best = torch.empty((N, T), dtype=torch.int32, device=logits.device)
    prob = torch.empty((N, T), dtype=torch.float32, device=logits.device)
    lib = _build.library()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.vse_ctc_argmax_lse(
            logits.data_ptr(), N * T, C, _threads_for(C),
            best.data_ptr(), prob.data_ptr(), stream,
        )
    _build.check(status, "vse_ctc_argmax_lse")
    return best, prob


def collapse(best: torch.Tensor, best_prob: torch.Tensor, blank: int = 0):
    """Collapse repeats and blanks, left-pack, mean kept prob (1.0 when
    nothing is kept) — the reference's plain-XLA tail of the decode."""
    N, T = best.shape
    prev = torch.cat(
        [torch.full((N, 1), -1, dtype=best.dtype, device=best.device),
         best[:, :-1]], dim=1,
    )
    keep = (best != blank) & (best != prev)
    n_kept = keep.sum(dim=1)
    score_sum = torch.where(keep, best_prob, torch.zeros_like(best_prob)).sum(1)
    scores = torch.where(
        n_kept > 0, score_sum / n_kept.clamp(min=1).to(score_sum.dtype),
        torch.ones_like(score_sum),
    )
    posn = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    # kept ids land at their packed slot; dropped ones in a spill column T
    slot = torch.where(keep, posn, torch.full_like(posn, T))
    ids = torch.zeros((N, T + 1), dtype=torch.int32, device=best.device)
    ids.scatter_(1, slot, best.to(torch.int32))
    mask = torch.arange(T, device=best.device)[None, :] < n_kept[:, None]
    return ids[:, :T], mask, scores.float()


def ctc_greedy_decode(
    logits: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, T, C] logits -> (ids [N, T] int32 left-packed, mask [N, T] bool,
    scores [N] f32), as ``vse_tpu.ops.ctc.ctc_greedy_decode``."""
    global launches
    if logits.is_cuda:
        best, prob = argmax_lse_cuda(logits)
        launches += 1
    elif logits.device.type == "cpu":
        best, prob = argmax_lse_plain(logits)
    else:
        raise ValueError(f"unsupported device {logits.device}")
    return collapse(best, prob)
