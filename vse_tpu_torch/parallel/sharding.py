"""How the OCR models and frame batches lay out on a (data, model) mesh of
cards (the port of ``vse_tpu/parallel/sharding.py``).

- Inference: the frame axis is the data axis. ``OcrEngine(mesh=...)`` keeps
  one det and rec replica on each device of the ``data`` axis and OCRs a
  contiguous chunk of each batch on each; parameters are replicated and
  nothing is exchanged between the cards.
- Training (``train/steps.py``): the data axis is ``torch.distributed``
  ranks, one process per card, each holding its slice of the global batch.
  The model axis is a layout only: a parameter stays whole on each rank of
  it (JAX's model axis is a GSPMD layout that leaves the numbers as they
  are). ``spec_for`` keeps the JAX package's model-parallel rules, keyed on
  a flax parameter path, for the day the model axis really shards.

A spec is a tuple with one mesh axis name (or None) per leading tensor
dimension, as a ``jax.sharding.PartitionSpec``; ``()`` is replicated.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

AXES = ("data", "model")
Spec = Tuple[Optional[str], ...]


class Mesh:
    """A 2-D array of ``torch.device``s with the axes ("data", "model")."""

    axis_names = AXES

    def __init__(self, devices):
        grid = np.empty(np.shape(devices)[:2], dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(devices[idx[0]][idx[1]])
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError("a mesh needs a non-empty [data, model] grid of devices")
        self.devices = grid

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def data_devices(self) -> List[torch.device]:
        """The device of each data index (model index 0)."""
        return list(self.devices[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_data: int = 0, n_model: int = 1,
              devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """A (n_data, n_model) mesh over ``devices`` (default: every CUDA
    device of this process; ``n_data`` 0 takes as many as fit). A device
    may be listed twice, e.g. two replicas on one card, or two CPU
    replicas."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device for the mesh; pass devices=[...] "
                               "(e.g. ['cpu', 'cpu']) to build one on the CPU")
    devices = [torch.device(d) for d in devices]
    if n_data <= 0:
        n_data = len(devices) // n_model
    if n_data * n_model > len(devices) or n_data <= 0:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs {max(n_data, 1) * n_model} "
                         f"devices, got {len(devices)}")
    flat = devices[: n_data * n_model]
    return Mesh([flat[i * n_model:(i + 1) * n_model] for i in range(n_data)])


@dataclass(frozen=True)
class Placement:
    """A tensor's leading dim split over a mesh's data axis (JAX's
    ``NamedSharding(mesh, P("data"))``)."""

    mesh: Mesh

    def shard(self, x: torch.Tensor) -> List[torch.Tensor]:
        """``x``'s piece for each data index, on that index's device: the
        leading dim in contiguous chunks (it must divide)."""
        devs = self.mesh.data_devices
        n = len(devs)
        if x.shape[0] % n:
            raise ValueError(f"a leading dim of {x.shape[0]} does not split over "
                             f"the data axis of size {n}")
        step = x.shape[0] // n
        return [x[i * step:(i + 1) * step].to(d) for i, d in enumerate(devs)]


def data_sharding(mesh: Mesh) -> Placement:
    """[B, ...] tensors: split the leading (frame / batch) axis."""
    return Placement(mesh)


# --- parameter partitioning (the model axis, a layout only) -----------------


def spec_for(path: str, shape: Sequence[int]) -> Spec:
    """The JAX package's model-parallel rules (``_spec_for``), keyed on a
    flax parameter path and its flax shape:

    - ``ctc_fc`` kernel / bias: the vocab (output) axis;
    - LSTM input / hidden kernels: the stacked-gate output axis;
    - conv kernels with >= 256 output channels: the output-channel axis;
    - everything else: replicated.
    """
    ndim = len(shape)
    if ndim == 0:
        return ()
    if "ctc_fc" in path:
        if ndim == 2:
            return (None, "model")
        if ndim == 1:
            return ("model",)
    if "lstm" in path and "kernel" in path.split("/")[-1] and ndim == 2:
        return (None, "model")
    if path.endswith("kernel") and ndim == 4 and shape[-1] >= 256:
        return (None, None, None, "model")
    return ()
