"""The optax pieces that training uses, on lists of torch tensors.

``vse_tpu/train/pretrain.py`` trains the rec head with
``optax.chain(clip_by_global_norm(1.0), adam(schedule))`` and the det with
``optax.adamw(schedule)``, each with ``warmup_cosine_decay_schedule(0, lr,
warmup, decay_steps)``. This module keeps optax's arithmetic and its state
layout, so a port run and a JAX run from the same parameters take the same
steps:

- a transform is an ``(init, update)`` pair; ``update(grads, state,
  params)`` returns ``(updates, state)`` and ``apply_updates`` adds the
  updates to the parameters in place;
- the schedule is evaluated at the count *before* the update (step 0 takes
  lr ``schedule(0)``, which is 0 after a warmup from 0), and ``decay_steps``
  counts the warmup, as in optax (which refuses ``decay_steps <= warmup``);
- clipping scales by ``max_norm / norm`` only where ``norm >= max_norm``
  (``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm +
  1e-6)`` where that is below 1);
- ``adamw``'s weight decay (1e-4) applies to every parameter, as
  ``optax.adamw(lr)`` with no mask does.

Counts are int32 tensors on the parameters' device and the schedule is
computed there, so an update needs no host sync; the arithmetic is
``torch._foreach_*`` over the parameter list, a few launches a step (its
roundings may differ from optax's in the last bit). ``state_to_flat`` /
``state_from_flat`` turn a state into flat numpy arrays for an npz.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]
Tensors = List[torch.Tensor]


class Transform(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors], Tuple[Tensors, Any]]


def _count(params: Tensors) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def _increment(count: torch.Tensor) -> torch.Tensor:
    """optax's ``safe_increment``: saturates at the int32 maximum."""
    return torch.where(count < torch.iinfo(torch.int32).max, count + 1, count)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count.float(), 0.0, float(transition_steps))
        frac = 1.0 - c / transition_steps
        return (init_value - end_value) * frac + end_value

    if transition_steps <= 0:
        return lambda count: torch.full((), init_value, device=count.device)
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={decay_steps}.")

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.minimum(count.float(), torch.tensor(float(decay_steps), device=count.device))
        cosine = 0.5 * (1.0 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine decay to ``end_value`` at
    ``decay_steps`` (which includes the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    cos = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        return torch.where(count < warmup_steps, warm(count), cos(count - warmup_steps))

    return schedule


def clip_by_global_norm(max_norm: float) -> Transform:
    def init(params):
        return ()

    def update(grads, state, params=None):
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        return torch._foreach_mul(grads, scale), state

    return Transform(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    def init(params):
        return {"count": _count(params), "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(grads, state, params=None):
        mu = torch._foreach_mul(state["mu"], b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        nu = torch._foreach_mul(state["nu"], b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        count = _increment(state["count"])
        c = count.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, device=c.device), c)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=c.device), c)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        updates = torch._foreach_div(mu, bc1)
        torch._foreach_div_(updates, denom)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return torch._foreach_add(grads, torch._foreach_mul(params, weight_decay)), state

    return Transform(init, update)


def scale_by_learning_rate(schedule: Schedule) -> Transform:
    def init(params):
        return {"count": _count(params)}

    def update(grads, state, params=None):
        step = -schedule(state["count"])
        return torch._foreach_mul(grads, step), {"count": _increment(state["count"])}

    return Transform(init, update)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new.append(s)
        return grads, tuple(new)

    return Transform(init, update)


def adam(schedule: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(schedule))


def adamw(schedule: Schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Transform:
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(schedule))


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    torch._foreach_add_(params, updates)


class Optimizer:
    """A transform bound to a list of parameters: ``step(grads)`` updates
    them in place and keeps the state."""

    def __init__(self, tx: Transform, params: Sequence[torch.Tensor]):
        self.tx = tx
        self.params = list(params)
        self.state = tx.init(self.params)

    @torch.no_grad()
    def step(self, grads: Tensors) -> None:
        updates, self.state = self.tx.update(list(grads), self.state, self.params)
        apply_updates(self.params, updates)


def state_to_flat(state: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A state (nested tuples, dicts and lists of tensors) -> flat numpy
    arrays keyed by their path, ``"0/mu/3"``."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(state, torch.Tensor):
        out[prefix.rstrip("/")] = state.detach().cpu().numpy()
    elif isinstance(state, dict):
        for k, v in state.items():
            out.update(state_to_flat(v, f"{prefix}{k}/"))
    else:
        for i, v in enumerate(state):
            out.update(state_to_flat(v, f"{prefix}{i}/"))
    return out


def state_from_flat(flat: Dict[str, np.ndarray], like: Any, prefix: str = "") -> Any:
    """The inverse of ``state_to_flat``, shaped and placed as ``like``;
    raises KeyError or ValueError when ``flat`` does not fit it."""
    if isinstance(like, torch.Tensor):
        arr = np.asarray(flat[prefix.rstrip("/")])
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{prefix}: shape {arr.shape} against {tuple(like.shape)}")
        return torch.as_tensor(arr, dtype=like.dtype).to(like.device)
    if isinstance(like, dict):
        return {k: state_from_flat(flat, v, f"{prefix}{k}/") for k, v in like.items()}
    items = [state_from_flat(flat, v, f"{prefix}{i}/") for i, v in enumerate(like)]
    return tuple(items) if isinstance(like, tuple) else items
