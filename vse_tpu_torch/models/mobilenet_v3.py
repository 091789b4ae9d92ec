"""MobileNetV3 recognition backbone (the port of
``vse_tpu/models/mobilenet_v3.py::MobileNetV3Rec``): small x0.5 for the
mobile heads, large x1.0 for the server head."""

from __future__ import annotations

import torch
import torch.nn as nn

from vse_tpu_torch.models import bf16 as B16

from vse_tpu_torch.models.common import ConvBNAct, InvertedResidual, make_divisible

# (kernel, expand, out, use_se, act, stride)
LARGE_CFG = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]

SMALL_CFG = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class MobileNetV3Rec(nn.Module):
    """Recognition backbone: NCHW [B, 3, 48, W] -> [B, W//4, C_out].

    The first stride-2 block downsamples both axes (W/4 in total with the
    stem); later ones stride (2, 1) so W survives as the CTC sequence axis.
    The remaining H is max-pooled away."""

    def __init__(self, scale: float = 0.5, arch: str = "small"):
        super().__init__()
        cfg = LARGE_CFG if arch == "large" else SMALL_CFG
        c = make_divisible(16 * scale)
        self.stem = ConvBNAct(3, c, (3, 3), (2, 2), act="hardswish")
        blocks = []
        downsamples_seen = 0
        for k, exp, out, use_se, act, stride in cfg:
            if stride == 2:
                strides = (2, 2) if downsamples_seen == 0 else (2, 1)
                downsamples_seen += 1
            else:
                strides = (1, 1)
            cout = make_divisible(out * scale)
            blocks.append(InvertedResidual(
                c, make_divisible(exp * scale), cout, (k, k), strides, use_se, act
            ))
            c = cout
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = make_divisible((960 if arch == "large" else 576) * scale)
        self.last = ConvBNAct(c, self.out_channels, (1, 1), act="hardswish")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for b in self.blocks:
            x = b(x)
        x = self.last(x)  # [B, C, H', W']
        return x.amax(dim=2).transpose(1, 2)  # [B, W', C]

    def forward_bf16(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's bf16 numerics (``models/bf16.py``)."""
        x = B16.rb(self.stem.forward_bf16(B16.rb(x)))
        for b in self.blocks:
            x = b.forward_bf16(x)
        x = B16.rb(self.last.forward_bf16(x))
        return x.amax(dim=2).transpose(1, 2)
