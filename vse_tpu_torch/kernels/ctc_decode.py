"""Greedy CTC decode: kernel K1 and its plain PyTorch version.

``csrc/ctc_decode.cu`` does the whole decode on the card: the class-axis
sweep over [N, T, C] logits (max, first-max argmax and log-sum-exp in one
read; C reaches ~21k for the CJK heads; f32, f16 or bf16, each value
converted to f32 as it is loaded) and the collapse of repeats and
blanks, the left-pack and the mean score. It replaces the Pallas kernel
``vse_tpu/kernels/ctc_decode.py::_argmax_lse_kernel`` and the plain-XLA
tail around it. Small heads (C <= FUSED_MAX_C) take one launch; larger ones
a row kernel and a collapse kernel, two launches, with no host sync and no
PyTorch op between them.

``ctc_greedy_decode`` launches the kernels for a CUDA tensor and uses the
plain version (``argmax_lse_plain`` then ``collapse``) only for a CPU
tensor; the plain version is also the oracle the kernels are held against.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vse_tpu_torch.kernels import _build

# decodes by ctc_greedy_decode that went through the CUDA kernels (plain-
# version calls and direct greedy_decode_cuda calls are not counted)
launches = 0


# the logits dtypes K1 reads, by the code its C entry takes
DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in one fixed order: the first half and the
    second half added elementwise (an odd last value carried along) until
    one value is left. Every add is an f32 elementwise op, so the bits do
    not depend on the intra-op thread count, the vector width or the storage
    offset, as those of ``torch.sum`` may (ROADMAP fault 14)."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        h = n // 2
        head = x[..., :h] + x[..., h : 2 * h]
        x = torch.cat([head, x[..., 2 * h :]], dim=-1) if n % 2 else head
    return x[..., 0]


def argmax_lse_plain(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, T, C] logits -> (best id [N, T] int32, softmax prob of best
    [N, T] f32), the first max on ties. Same arithmetic as the Pallas body,
    which casts any float dtype to f32 first; the sum over C has a fixed
    order (``tree_sum``)."""
    x = logits.float()
    m, _ = x.max(dim=-1)
    best = torch.argmax(x, dim=-1).to(torch.int32)  # first maximal index
    lse = m + torch.log(tree_sum(torch.exp(x - m[..., None])))
    return best, torch.exp(m - lse)


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
    score_sum = tree_sum(torch.where(keep, best_prob, torch.zeros_like(best_prob)))
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


# the fused one-launch path takes heads up to this many classes and as many
# steps as fit its 8 bytes a step of shared memory (48 KiB without opt-in)
FUSED_MAX_C = 1024
FUSED_MAX_T = 6144


def decode_plan(T: int, C: int) -> Tuple[bool, int, int]:
    """(fused, lanes a step in the fused kernel, threads a block of the row
    kernel) for a [*, T, C] decode."""
    fused = C <= FUSED_MAX_C and T <= FUSED_MAX_T
    lanes = 8 if C <= 128 else 16 if C <= 512 else 32
    return fused, lanes, (256 if C >= 8192 else 128)


def alloc_outputs(N: int, T: int, device):
    """One allocation for ids [N, T] int32, scores [N] f32, the row kernel's
    workspace (best int32 and prob f32, [N * T] each, as raw bytes) and mask
    [N, T] bool, in that order. Returns (ids, mask, scores, workspace)."""
    nt = N * T
    buf = torch.empty(nt * 13 + N * 4, dtype=torch.uint8, device=device)
    ids, scores, ws, mask = buf.split([nt * 4, N * 4, nt * 8, nt])
    return (ids.view(torch.int32).view(N, T), mask.view(torch.bool).view(N, T),
            scores.view(torch.float32), ws)


def launch(logits: torch.Tensor, ids, mask, scores, ws) -> None:
    """One K1 decode into preallocated buffers (``alloc_outputs``)."""
    N, T, C = logits.shape
    fused, lanes, threads = decode_plan(T, C)
    with _build.on_device(logits):
        status = _build.library().vse_ctc_greedy_decode(
            logits.data_ptr(), N, T, C, DTYPES[logits.dtype], int(fused),
            lanes, threads, ws.data_ptr(), ws.data_ptr() + N * T * 4, ids.data_ptr(),
            mask.data_ptr(), scores.data_ptr(), _build.stream_of(logits),
        )
    _build.check(status, "vse_ctc_greedy_decode")


def greedy_decode_cuda(
    logits: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K1 on contiguous f32, f16 or bf16 CUDA logits [N, T, C] (not
    counted)."""
    if not logits.is_cuda:
        raise ValueError("greedy_decode_cuda needs a CUDA tensor")
    if logits.dtype not in DTYPES:
        raise TypeError(f"K1 takes float32, float16 or bfloat16 logits, got {logits.dtype}")
    if logits.dim() != 3 or logits.shape[2] < 1:
        raise ValueError(f"K1 takes [N, T, C >= 1] logits, got {tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("K1 takes contiguous logits")
    N, T, _ = logits.shape
    ids, mask, scores, ws = alloc_outputs(N, T, logits.device)
    launch(logits, ids, mask, scores, ws)
    return ids, mask, scores


def ctc_greedy_decode(
    logits: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[N, T, C] logits -> (ids [N, T] int32 left-packed, mask [N, T] bool,
    scores [N] f32), as ``vse_tpu.ops.ctc.ctc_greedy_decode``."""
    global launches
    if logits.is_cuda:
        out = greedy_decode_cuda(logits)
        launches += 1
        return out
    if logits.device.type == "cpu":
        return collapse(*argmax_lse_plain(logits))
    raise ValueError(f"unsupported device {logits.device}")
