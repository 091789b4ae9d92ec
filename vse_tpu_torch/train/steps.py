"""The joint det + rec train step over a (data, model) mesh (the port of
``vse_tpu/train/steps.py``).

One step trains both models: the mobile DB detector (training outputs) on
``db_loss`` and the CRNN on ``ctc_rec_loss``, both in training mode (batch
statistics, running statistics moved), then one ``adamw`` update at a
constant learning rate over ``{"det", "rec"}`` (``optax.adamw(lr)``).

The step is functional, as the JAX package's: the modules are definitions,
and ``TrainState`` holds their variables (``det_params`` / ``rec_params``:
name -> tensor, parameters and BatchNorm statistics) and the optimizer
state; ``torch.func.functional_call`` runs a module on them.

The step runs on the card: ``make_models`` builds the models there and
``mesh=None`` means ``cuda``; only a mesh of CPU devices runs it on the
CPU. Every device goes through ``device.resolve_device``, which also turns
TF32 off, so the step computes in f32 in a fresh process too.

The data axis is ``torch.distributed`` ranks, one process per device
(``parallel/multihost.py::initialize``). JAX's GSPMD step computes one
program over the global batch; each rank here holds a contiguous slice of
it and the step computes the same numbers: BatchNorm statistics over the
global batch (``models/common.py::BatchNorm``), the hard-negative sort over
the all-gathered negatives and the means over global counts
(``train/losses.py``), and the gradients all-reduced before the optimizer.
A data axis of size 1 takes no process group and no collective. The model
axis is a layout only: each parameter stays whole on each rank of the
axis, which computes what the other ranks of its data slice compute
(``parallel/sharding.py::spec_for`` gives the JAX package's specs).

The JAX step runs its models in bf16 (flax's default ``dtype``); this one,
like ``train/pretrain.py`` in both packages, computes in f32.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.func import functional_call

from vse_tpu_torch.device import resolve_device
from vse_tpu_torch.models.common import sync_batch_norm
from vse_tpu_torch.models.crnn import CRNNRecognizer
from vse_tpu_torch.models.db_detector import DBDetector
from vse_tpu_torch.parallel.sharding import Mesh
from vse_tpu_torch.train import optim
from vse_tpu_torch.train.losses import ctc_rec_loss, db_loss

Variables = Dict[str, torch.Tensor]
DET_KEYS = ("det_images", "gt_shrink", "gt_shrink_mask", "gt_thresh", "gt_thresh_mask")


@dataclass
class TrainState:
    det_params: Variables
    rec_params: Variables
    opt_state: Any
    step: torch.Tensor  # scalar int32


def make_models(vocab_size: int, det_variant: str = "mobile", rec_variant: str = "mobile",
                device: Union[str, torch.device] = "cuda"):
    """The two models on ``device`` (the card unless the caller asks for
    the CPU); ``init_state`` / ``load_state`` build the state there."""
    device = resolve_device(device)
    det = DBDetector(variant=det_variant, train_outputs=True).to(device)
    rec = CRNNRecognizer(vocab_size=vocab_size, variant=rec_variant).to(device)
    return det, rec


def _variables(model: nn.Module) -> Variables:
    """The module's parameters (leaves with its ``requires_grad``) and
    buffers, detached copies."""
    out = {k: p.detach().clone().requires_grad_(p.requires_grad)
           for k, p in model.named_parameters()}
    out.update({k: b.detach().clone() for k, b in model.named_buffers()})
    return out


def _trainable(model: nn.Module, variables: Variables) -> list:
    return [variables[k] for k, p in model.named_parameters() if p.requires_grad]


def adamw(lr: float) -> optim.Transform:
    """``optax.adamw(lr)``: a constant learning rate, weight decay 1e-4 on
    every parameter."""
    return optim.adamw(optim.linear_schedule(lr, lr, 0))


def state_from_models(det: nn.Module, rec: nn.Module, tx: optim.Transform) -> TrainState:
    """A fresh state (step 0, the optimizer's init) on the models' current
    variables."""
    det_v, rec_v = _variables(det), _variables(rec)
    params = _trainable(det, det_v) + _trainable(rec, rec_v)
    step = torch.zeros((), dtype=torch.int32, device=params[0].device)
    return TrainState(det_v, rec_v, tx.init(params), step)


def init_state(det: DBDetector, rec: CRNNRecognizer, lr: float = 1e-3, seed: int = 0
               ) -> Tuple[TrainState, optim.Transform]:
    """Initialize both models as flax initializes them (``pretrain.flax_init``;
    the values differ from ``jax.random``'s) and the optimizer. The JAX
    signature's sample input shapes have no counterpart: a torch module
    knows its parameters' shapes without a trace."""
    from vse_tpu_torch.train.pretrain import flax_init

    flax_init(det, seed)
    flax_init(rec, seed + 1)
    tx = adamw(lr)
    return state_from_models(det, rec, tx), tx


def load_state(det: DBDetector, rec: CRNNRecognizer, det_flat: Dict[str, np.ndarray],
               rec_flat: Dict[str, np.ndarray], lr: float = 1e-3
               ) -> Tuple[TrainState, optim.Transform]:
    """A state at step 0 from flat flax variables (a JAX ``init_state``'s
    ``det_params`` / ``rec_params`` flattened with ``/``)."""
    from vse_tpu_torch.weights import from_jax_det, from_jax_params

    det.load_state_dict(from_jax_det(det_flat))
    rec.load_state_dict(from_jax_params(rec_flat))
    tx = adamw(lr)
    return state_from_models(det, rec, tx), tx


def _cell(mesh: Optional[Mesh]):
    """(data index, device) of this process on ``mesh``, the device
    resolved (``device.resolve_device``): under ``torch.distributed`` rank r
    is cell r of the mesh, row-major; in one process the mesh must have one
    data index. No mesh: the card."""
    if mesh is None:
        return 0, resolve_device("cuda")
    if not (dist.is_available() and dist.is_initialized()):
        if mesh.shape["data"] != 1:
            raise ValueError(
                f"a data axis of {mesh.shape['data']} needs one process per device: "
                "initialize torch.distributed (parallel/multihost.py::initialize, torchrun)")
        return 0, resolve_device(mesh.devices[0, 0])
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != mesh.size:
        raise ValueError(f"the mesh has {mesh.size} cells, the process group {world} ranks")
    return rank // mesh.shape["model"], resolve_device(mesh.devices.flat[rank])


def _data_group(mesh: Optional[Mesh]):
    """This rank's data-axis group (the ranks of its model column), made
    by every rank in the same order; None where the data axis has one
    index (the whole batch is local: no collective)."""
    _cell(mesh)
    if mesh is None or mesh.shape["data"] == 1:
        return None
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    groups = [dist.new_group([i * n_model + j for i in range(n_data)]) for j in range(n_model)]
    return groups[dist.get_rank() % n_model]


def make_train_step(det: DBDetector, rec: CRNNRecognizer, tx: optim.Transform,
                    mesh: Optional[Mesh] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: det_images [B, H, W, 3], gt_shrink / gt_shrink_mask / gt_thresh /
    gt_thresh_mask [B, H, W]; rec_images [b, h, w, 3], labels [b, L],
    label_lengths [b] (this rank's slice, ``place_batch``). The state's
    variables are updated in place and returned in a new ``TrainState``.
    Under ``torch.distributed`` every rank of the mesh must call it (the
    data-axis groups are made here)."""
    group = _data_group(mesh)
    _, device = _cell(mesh)
    for model in (det, rec):
        sync_batch_norm(model, group).to(device)
    n_data = dist.get_world_size(group) if group is not None else 1

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        det.train()
        rec.train()
        prob, thresh, binary = functional_call(det, state.det_params, (batch["det_images"],))
        dloss, dmetrics = db_loss(prob, thresh, binary, *(batch[k] for k in DET_KEYS[1:]),
                                  group=group)
        logits = functional_call(rec, state.rec_params, (batch["rec_images"],))
        rloss = ctc_rec_loss(logits, batch["labels"], batch["label_lengths"], group=group)
        total = dloss + rloss
        params = _trainable(det, state.det_params) + _trainable(rec, state.rec_params)
        grads = torch.autograd.grad(total, params)
        if group is not None:
            # each rank's gradient is n_data times its share (losses.py)
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=group)
            flat /= n_data
            grads = [v.view_as(g) for v, g in zip(flat.split([g.numel() for g in grads]), grads)]
        updates, opt_state = tx.update(list(grads), state.opt_state, params)
        optim.apply_updates(params, updates)
        metrics = {"loss": total, "det_loss": dloss, "rec_loss": rloss, **dmetrics}
        return (replace(state, opt_state=opt_state, step=state.step + 1),
                {k: v.detach() for k, v in metrics.items()})

    return train_step


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.detach().to(device).requires_grad_(x.requires_grad)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def shard_state(mesh: Mesh, state: TrainState) -> TrainState:
    """Place the state on this process's device of the mesh: the variables,
    the optimizer moments and the step, each whole (the model axis is a
    layout only)."""
    _, device = _cell(mesh)
    return TrainState(_to(state.det_params, device), _to(state.rec_params, device),
                      _to(state.opt_state, device), state.step.to(device))


def place_batch(mesh: Optional[Mesh], batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """This process's slice of a global batch, on its device: each array's
    leading dim split over the data axis (it must divide, as JAX's
    ``device_put`` requires)."""
    index, device = _cell(mesh)
    n_data = 1 if mesh is None else mesh.shape["data"]
    out = {}
    for k, v in batch.items():
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        if v.shape[0] % n_data:
            raise ValueError(f"{k}: a batch of {v.shape[0]} does not split over "
                             f"the data axis of size {n_data}")
        step = v.shape[0] // n_data
        out[k] = v[index * step:(index + 1) * step].to(device)
    return out
