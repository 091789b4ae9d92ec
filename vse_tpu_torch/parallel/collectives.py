"""Collectives over the data axis of a training step (``train/steps.py``),
each a no-op when the group is None (one process holds the whole batch).

The sum and the gather carry their gradient. They are two small autograd
functions rather than ``torch.distributed.nn.functional``'s: that module's
``all_gather`` scatters its gradient from group-local ranks as if they were
global ones, which fails in a subgroup (each model column of a (d, m) mesh
is one).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _CatOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        i = dist.get_rank(ctx.group)
        return grad[i * ctx.n:(i + 1) * ctx.n], None


def global_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks, with the gradient (the sum of
    the ranks' gradients flows back to each)."""
    return x if group is None else _SumOverRanks.apply(x, group)


def global_count(x: torch.Tensor, group=None) -> torch.Tensor:
    """An integer count summed over ``group``'s ranks (no gradient)."""
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def global_cat(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated in rank order along dim
    0, with the gradient (each rank's slice of the summed gradient)."""
    return x if group is None else _CatOverRanks.apply(x, group)
