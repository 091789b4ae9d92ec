"""Shared PyTorch building blocks for the recognition model (the port of
``vse_tpu/models/common.py``).

Parity notes against the flax reference:

- flax ``padding="SAME"`` pads ASYMMETRICALLY where the stride does not
  divide evenly (k3 s2 on an even size pads 0 before / 1 after, k5 s2 pads
  1 / 2); ``same_pad`` reproduces it with an explicit ``F.pad``, since
  torch's ``padding=k//2`` is symmetric.
- the MobileNetV3 hard-sigmoid is ``clip(x/6 + 0.5, 0, 1)`` (the PP-OCR det
  SE uses a different one, see ``ppocr_det.py``).
- the SE mid width is ``make_divisible(C // 4)``.

Each block also has ``forward_bf16``, the reference's bf16 numerics
(``models/bf16.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vse_tpu_torch.models import bf16 as B16


def make_divisible(v: float, divisor: int = 8, min_value: Optional[int] = None) -> int:
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * hard_sigmoid(x)


ACTS = {
    "relu": F.relu,
    "hardswish": hard_swish,
    None: lambda x: x,
}


def same_pad(x: torch.Tensor, kernel: Tuple[int, int], strides: Tuple[int, int]) -> torch.Tensor:
    """Pad NCHW ``x`` as XLA's "SAME" does: total = max((ceil(n/s)-1)*s + k
    - n, 0), with the smaller half before."""
    pads = []
    for n, k, s in ((x.shape[3], kernel[1], strides[1]),
                    (x.shape[2], kernel[0], strides[0])):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ConvBNAct(nn.Module):
    """Conv2D ("SAME", no bias) + BatchNorm + activation; groups>1 is
    depthwise."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), strides=(1, 1),
                 groups: int = 1, act: Optional[str] = "relu"):
        super().__init__()
        self.kernel = tuple(kernel)
        self.strides = tuple(strides)
        self.conv = nn.Conv2d(cin, cout, self.kernel, self.strides,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)
        self.act = ACTS[act]
        self.act_name = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(same_pad(x, self.kernel, self.strides))))

    def forward_bf16(self, x: torch.Tensor) -> torch.Tensor:
        """bf16 ``x`` -> the activation's output before its last rounding
        (``B16.rb`` it for a bf16 consumer)."""
        y = B16.conv(self.conv, same_pad(x, self.kernel, self.strides))
        return B16.act_raw(self.act_name, B16.rb(B16.batch_norm(self.bn, y)))


class SEBlock(nn.Module):
    """Squeeze-and-excitation with the x/6+0.5 hard-sigmoid gate."""

    def __init__(self, ch: int, reduction: int = 4):
        super().__init__()
        mid = make_divisible(ch // reduction)
        self.conv1 = nn.Conv2d(ch, mid, 1)
        self.conv2 = nn.Conv2d(mid, ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv2(F.relu(self.conv1(s)))
        return x * hard_sigmoid(s)

    def forward_bf16(self, x: torch.Tensor, x_raw: torch.Tensor) -> torch.Tensor:
        """``x`` rounded; ``x_raw`` the same values before rounding, which
        the mean reads."""
        s = B16.conv_bias(self.conv2, F.relu(B16.conv_bias(self.conv1, B16.mean_hw(x_raw))))
        return B16.rb(x * B16.hard_sigmoid(s))


class InvertedResidual(nn.Module):
    """MobileNetV3 inverted residual: expand 1x1 -> depthwise -> (SE) ->
    project."""

    def __init__(self, cin: int, expand: int, cout: int, kernel, strides,
                 use_se: bool, act: str):
        super().__init__()
        self.expand = ConvBNAct(cin, expand, (1, 1), act=act)
        self.dw = ConvBNAct(expand, expand, kernel, strides, groups=expand, act=act)
        self.se = SEBlock(expand) if use_se else None
        self.project = ConvBNAct(expand, cout, (1, 1), act=None)
        self.residual = tuple(strides) == (1, 1) and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dw(self.expand(x))
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        return x + y if self.residual else y

    def forward_bf16(self, x: torch.Tensor) -> torch.Tensor:
        y = B16.rb(self.expand.forward_bf16(x))
        y_raw = self.dw.forward_bf16(y)
        y = B16.rb(y_raw)
        if self.se is not None:
            y = self.se.forward_bf16(y, y_raw)
        y = B16.rb(self.project.forward_bf16(y))
        return B16.rb(x + y) if self.residual else y
