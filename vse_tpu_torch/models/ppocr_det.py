"""PP-OCRv3 mobile DB detector (the port of
``vse_tpu/models/ppocr_det.py::PPOCRv3DetMobile``).

  backbone: MobileNetV3-large x0.5, SE disabled, stem 8ch; features at
            /4 (16ch) /8 (24ch) /16 (56ch) /32 (480ch)
  neck:     RSEFPN(96): 1x1 residual-SE laterals, nearest-up top-down adds,
            3x3 residual-SE smoothing to 24ch, concat at /4 deepest-first
  head:     DB binarize branch: 3x3 conv-bn-relu, two 2x2 stride-2
            transposed convs, sigmoid

Module names follow the paddle parameter names of
``checkpoints/ppocr_v3_det_mobile.npz``, which is already in torch layout
(OIHW convs, (I, O, H, W) transposed convs, no flip), so ``weights.
load_det_npz`` only renames the BatchNorm statistics. Convs pad
symmetrically at k//2 like paddle (torch's own padding); the SE gate is
paddle's hard-sigmoid ``clip(0.2x + 0.5)`` with a plain ``C // 4`` mid width.

``forward`` computes in f32 (the architecture check against the flax module
in f32); after ``models.bf16.emulate`` it takes each module's
``forward_bf16``, the reference's bf16 numerics (``models/bf16.py``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from vse_tpu_torch.models import bf16 as B16
from vse_tpu_torch.models.common import hard_swish

ACT = {"relu": F.relu, "hardswish": hard_swish, None: lambda x: x}

# (kernel, expand, out, stride, act) per stage — MobileNetV3-large x0.5
STAGES = [
    [(3, 8, 8, 1, "relu"), (3, 32, 16, 2, "relu"), (3, 40, 16, 1, "relu")],
    [(5, 40, 24, 2, "relu"), (5, 64, 24, 1, "relu"), (5, 64, 24, 1, "relu")],
    [(3, 120, 40, 2, "hardswish"), (3, 104, 40, 1, "hardswish"),
     (3, 96, 40, 1, "hardswish"), (3, 96, 40, 1, "hardswish"),
     (3, 240, 56, 1, "hardswish"), (3, 336, 56, 1, "hardswish")],
    [(5, 336, 80, 2, "hardswish"), (5, 480, 80, 1, "hardswish"),
     (5, 480, 80, 1, "hardswish")],
]


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, s: int = 1,
                 groups: int = 1, act=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, padding=k // 2, groups=groups,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)
        self.act = ACT[act]
        self.act_name = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))

    def forward_bf16(self, x: torch.Tensor) -> torch.Tensor:
        y = B16.rb(B16.batch_norm(self.bn, B16.conv(self.conv, x)))
        return B16.rb(B16.act_raw(self.act_name, y))


class ResidualUnit(nn.Module):
    def __init__(self, cin: int, exp: int, out: int, k: int, s: int, act: str):
        super().__init__()
        self.expand_conv = ConvBN(cin, exp, 1, act=act)
        self.bottleneck_conv = ConvBN(exp, exp, k, s, groups=exp, act=act)
        self.linear_conv = ConvBN(exp, out, 1)
        self.residual = s == 1 and cin == out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.linear_conv(self.bottleneck_conv(self.expand_conv(x)))
        return x + y if self.residual else y

    def forward_bf16(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand_conv.forward_bf16(x)
        y = self.linear_conv.forward_bf16(self.bottleneck_conv.forward_bf16(y))
        return B16.rb(x + y) if self.residual else y


class Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = ConvBN(3, 8, 3, 2, act="hardswish")
        c = 8
        for si, blocks in enumerate(STAGES):
            units = []
            for k, exp, out, s, act in blocks:
                units.append(ResidualUnit(c, exp, out, k, s, act))
                c = out
            if si == 3:
                # the final 1x1 expansion sits inside stage3 (index 3)
                units.append(ConvBN(c, 480, 1, act="hardswish"))
            setattr(self, f"stage{si}", nn.Sequential(*units))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.conv(x)
        feats = []
        for si in range(4):
            x = getattr(self, f"stage{si}")(x)
            feats.append(x)
        return feats

    def forward_bf16(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.conv.forward_bf16(B16.rb(x))
        feats = []
        for si in range(4):
            for unit in getattr(self, f"stage{si}"):
                x = unit.forward_bf16(x)
            feats.append(x)
        return feats


class SEBlockP(nn.Module):
    """Paddle SE: conv1(+bias) relu, conv2(+bias), hardsigmoid 0.2x+0.5."""

    def __init__(self, ch: int, r: int = 4):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch // r, 1)
        self.conv2 = nn.Conv2d(ch // r, ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv2(F.relu(self.conv1(s)))
        return x * torch.clamp(0.2 * s + 0.5, 0.0, 1.0)

    def forward_bf16(self, x: torch.Tensor, x_raw: torch.Tensor) -> torch.Tensor:
        """``x`` rounded; ``x_raw`` the same values before rounding, which
        the mean reads."""
        s = B16.conv_bias(self.conv2, torch.relu(B16.conv_bias(self.conv1, B16.mean_hw(x_raw))))
        s = torch.clamp(B16.rb(B16.rb(s * B16.POINT2_BF16) + 0.5), 0.0, 1.0)
        return B16.rb(x * s)


class RSELayer(nn.Module):
    def __init__(self, cin: int, out: int, k: int):
        super().__init__()
        self.in_conv = nn.Conv2d(cin, out, k, padding=k // 2, bias=False)
        self.se_block = SEBlockP(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.in_conv(x)
        return y + self.se_block(y)

    def forward_bf16(self, x: torch.Tensor) -> torch.Tensor:
        y_raw = B16.conv(self.in_conv, x)
        y = B16.rb(y_raw)
        return B16.rb(y + self.se_block.forward_bf16(y, y_raw))


def _up2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class RSEFPN(nn.Module):
    def __init__(self, in_channels=(16, 24, 56, 480), out_channels: int = 96):
        super().__init__()
        c = out_channels
        self.ins_conv = nn.ModuleList(RSELayer(ci, c, 1) for ci in in_channels)
        self.inp_conv = nn.ModuleList(RSELayer(c, c // 4, 3) for _ in in_channels)

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        lat = [m(f) for m, f in zip(self.ins_conv, feats)]
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = lat[i] + _up2(lat[i + 1])
        outs = []
        for i, f in enumerate(lat):
            p = self.inp_conv[i](f)
            for _ in range(i):
                p = _up2(p)
            outs.append(p)
        return torch.cat(outs[::-1], dim=1)

    def forward_bf16(self, feats: List[torch.Tensor]) -> torch.Tensor:
        lat = [m.forward_bf16(f) for m, f in zip(self.ins_conv, feats)]
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = B16.rb(lat[i] + _up2(lat[i + 1]))
        outs = []
        for i, f in enumerate(lat):
            p = self.inp_conv[i].forward_bf16(f)
            for _ in range(i):
                p = _up2(p)
            outs.append(p)
        return torch.cat(outs[::-1], dim=1)


class DBHead(nn.Module):
    def __init__(self, cin: int = 96):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, 24, 3, padding=1, bias=False)
        self.conv_bn1 = nn.BatchNorm2d(24, eps=1e-5)
        self.conv2 = nn.ConvTranspose2d(24, 24, 2, stride=2)
        self.conv_bn2 = nn.BatchNorm2d(24, eps=1e-5)
        self.conv3 = nn.ConvTranspose2d(24, 1, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv_bn1(self.conv1(x)))
        x = F.relu(self.conv_bn2(self.conv2(x)))
        return torch.sigmoid(self.conv3(x))

    def forward_bf16(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(B16.rb(B16.batch_norm(self.conv_bn1, B16.conv(self.conv1, x))))
        x = B16.rb(B16.conv(self.conv2, x)) + self.conv2.bias[:, None, None]
        x = torch.relu(B16.rb(B16.batch_norm(self.conv_bn2, x)))
        x = B16.rb(B16.conv(self.conv3, x)) + self.conv3.bias[:, None, None]
        return B16.sigmoid(x)


class Head(nn.Module):
    def __init__(self):
        super().__init__()
        self.binarize = DBHead()


class PPOCRv3DetMobile(nn.Module):
    """Normalized NHWC images [B, H, W, 3] (H, W multiples of 32) -> DB
    probability map [B, H, W]."""

    def __init__(self):
        super().__init__()
        self.backbone = Backbone()
        self.neck = RSEFPN()
        self.head = Head()
        self.bf16 = False

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        if self.bf16:
            return self.head.binarize.forward_bf16(
                self.neck.forward_bf16(self.backbone.forward_bf16(x)))[:, 0]
        return self.head.binarize(self.neck(self.backbone(x)))[:, 0]
