"""The benchmark's fixed arithmetic: the chip's published peaks, the
operations of a det or rec forward from its input shape, and the bytes a
kernel launch has to move.

Peaks are NVIDIA's H100 SXM data sheet (dense, no sparsity): 989 TFLOP/s in
bfloat16, the precision the configurations state, and 3.35 TB/s of HBM.
They assume the 700 W power limit; each traced run records the card's own
limit beside them.

A forward's operations are counted from the reference models' layer
shapes: 2 x multiply-adds of every convolution, transposed convolution,
dense layer and LSTM (both directions, all four gates), plus what the
model kind's ``extra_flops`` counts outside those calls; normalization,
activations and adds are not counted. A kernel's bytes count each input
byte read once and each output byte written once.
"""

from __future__ import annotations

import functools
import json
from typing import Tuple

import torch
import torch.nn as nn

from reference import arch
from reference import models as M

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _forward_flops(model: nn.Module, shape: Tuple[int, ...]) -> int:
    total = [0]

    def hook(m, args, out):
        x = args[0]
        if isinstance(m, nn.Conv2d):
            k = m.kernel_size[0] * m.kernel_size[1] * m.in_channels // m.groups
            total[0] += 2 * out.numel() * k
        elif isinstance(m, nn.ConvTranspose2d):
            k = m.kernel_size[0] * m.kernel_size[1] * m.out_channels // m.groups
            total[0] += 2 * x.numel() * k
        elif isinstance(m, nn.Linear):
            total[0] += 2 * (x.numel() // m.in_features) * m.in_features * m.out_features
        elif isinstance(m, nn.LSTM):
            n, t, i = x.shape
            h = m.hidden_size
            dirs = 2 if m.bidirectional else 1
            total[0] += dirs * n * t * 2 * 4 * h * (i + h)

    handles = [m.register_forward_hook(hook) for m in M.layers_of(model)]
    try:
        model(torch.empty(shape, device="meta"))
    finally:
        for h in handles:
            h.remove()
    return total[0]


@functools.lru_cache(maxsize=None)
def _flops(section: str, shape: Tuple[int, ...]) -> int:
    sec = json.loads(section)
    kind = arch.of(sec)
    with torch.device("meta"):
        model = kind.build(sec).eval()
    return _forward_flops(model, shape) + int(kind.extra_flops(sec, shape))


def forward_flops(section: dict, shape: Tuple[int, ...]) -> int:
    """Operations of one forward of the model that a configuration's ``det``
    or ``rec`` section describes (``reference/arch/<kind>.py``) on an NHWC
    input of ``shape``."""
    return _flops(json.dumps(section, sort_keys=True), tuple(shape))


def k1_bytes(n: int, t: int, c: int, itemsize: int = 4) -> int:
    """Greedy CTC decode of [n, t, c] logits: the logits read once; ids
    (int32), mask (bool) and scores (f32) written once."""
    return n * t * c * itemsize + n * t * (4 + 1) + n * 4


def k2_bytes(t: int, h: int, w: int) -> int:
    """Keyframe stats of a uint8 band [t, h, w, 3]: the band read once, four
    f32 stats a frame written once."""
    return t * h * w * 3 + t * 4 * 4
