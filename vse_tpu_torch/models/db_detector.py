"""DB text detector of the JAX package's own design (the port of
``vse_tpu/models/db_detector.py``): backbone -> FPN neck -> binarization
head, as the server (ResNet-50, FPN 256) or the mobile (MobileNetV3-large
x0.5, FPN 96) variant. Accurate mode and, on the card, auto mode run the
server variant on the exported ``det_server`` weights
(``weights.load_det_server``); the fast mode's det is ``ppocr_det.py``.

  backbone: ResNet bottleneck blocks, depths 3-4-6-3, after a 7x7/2 stem
            and a 3x3/2 max pool; features at /4 /8 /16 /32 (256, 512,
            1024, 2048 channels)
  neck:     1x1 laterals to 256, nearest-up top-down adds, per-level 3x3
            smoothing to 64, upsampled to /4 and concatenated shallowest
            first
  head:     3x3 conv-bn-relu, 2x2/2 transposed conv, BatchNorm, relu,
            2x2/2 transposed conv to one channel, sigmoid

Parity notes: convolutions pad as XLA's "SAME" (``common.same_pad``), the
max pool too, with -inf (0 before and 1 after on an even size); flax's
``ConvTranspose`` is a correlation, so ``weights`` flips its kernel for
``nn.ConvTranspose2d``. ``forward`` computes in f32 (the architecture check
against the flax module in f32); after ``models.bf16.emulate`` it takes
``forward_bf16``, the reference's bf16 numerics (``models/bf16.py``): every
ConvBNAct result is bf16, the residual and top-down adds are rounded bf16
adds, the head's transposed-conv sums feed its BatchNorm unrounded but for
the conv product, and the sigmoid is f32.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vse_tpu_torch.models import bf16 as B16
from vse_tpu_torch.models.common import BatchNorm, ConvBNAct, InvertedResidual, make_divisible, same_pad
from vse_tpu_torch.models.mobilenet_v3 import LARGE_CFG


def upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsample of NCHW ``x`` by a static factor."""
    if factor == 1:
        return x
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def max_pool_same(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.max_pool(x, (3, 3), (2, 2), "SAME")`` on NCHW ``x``: the
    padding XLA's "SAME" gives, filled with -inf."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), 3, 2)


class ResNetBlock(nn.Module):
    """Bottleneck: 1x1 -> 3x3 (strided) -> 1x1 to 4x, a projected shortcut
    where the shape changes, relu of the sum."""

    def __init__(self, cin: int, features: int, strides=(1, 1)):
        super().__init__()
        self.conv1 = ConvBNAct(cin, features, (1, 1), act="relu")
        self.conv2 = ConvBNAct(features, features, (3, 3), strides, act="relu")
        self.conv3 = ConvBNAct(features, features * 4, (1, 1), act=None)
        self.shortcut = None
        if tuple(strides) != (1, 1) or cin != features * 4:
            self.shortcut = ConvBNAct(cin, features * 4, (1, 1), strides, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3(self.conv2(self.conv1(x)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return F.relu(x + y)

    def forward_bf16(self, x: torch.Tensor) -> torch.Tensor:
        y = B16.rb(self.conv1.forward_bf16(x))
        y = B16.rb(self.conv2.forward_bf16(y))
        y = B16.rb(self.conv3.forward_bf16(y))
        if self.shortcut is not None:
            x = B16.rb(self.shortcut.forward_bf16(x))
        return torch.relu(B16.rb(x + y))


class ResNetDet(nn.Module):
    """ResNet-50-style backbone: NCHW images -> features at /4 /8 /16 /32."""

    def __init__(self, depths: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.stem = ConvBNAct(3, 64, (7, 7), (2, 2), act="relu")
        blocks = []
        cin, features = 64, 64
        self.stage_ends = []
        for i, depth in enumerate(depths):
            for j in range(depth):
                strides = (2, 2) if (j == 0 and i > 0) else (1, 1)
                blocks.append(ResNetBlock(cin, features, strides))
                cin = features * 4
            self.stage_ends.append(len(blocks) - 1)
            features *= 2
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = [64 * 4 * 2 ** i for i in range(len(depths))]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = max_pool_same(self.stem(x))
        feats = []
        for i, b in enumerate(self.blocks):
            x = b(x)
            if i in self.stage_ends:
                feats.append(x)
        return feats

    def forward_bf16(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = max_pool_same(B16.rb(self.stem.forward_bf16(B16.rb(x))))
        feats = []
        for i, b in enumerate(self.blocks):
            x = b.forward_bf16(x)
            if i in self.stage_ends:
                feats.append(x)
        return feats


class MobileNetV3Det(nn.Module):
    """MobileNetV3-large detection backbone: features at /4 /8 /16 /32 (the
    level before each stride-2 block, and the final 1x1 expansion)."""

    def __init__(self, scale: float = 0.5):
        super().__init__()
        c = make_divisible(16 * scale)
        self.stem = ConvBNAct(3, c, (3, 3), (2, 2), act="hardswish")
        blocks, self.taps = [], []
        for k, exp, out, use_se, act, stride in LARGE_CFG:
            if stride == 2:
                self.taps.append(len(blocks))  # the input of block len(blocks)
            cout = make_divisible(out * scale)
            blocks.append(InvertedResidual(c, make_divisible(exp * scale), cout, (k, k),
                                           (stride, stride), use_se, act))
            c = cout
        self.blocks = nn.ModuleList(blocks)
        last = make_divisible(960 * scale)
        self.last = ConvBNAct(c, last, (1, 1), act="hardswish")
        self.out_channels = [make_divisible(LARGE_CFG[t - 1][2] * scale)
                             for t in self.taps[1:]] + [last]

    def _run(self, x, block, last):
        feats = []
        for i, b in enumerate(self.blocks):
            if i in self.taps:
                feats.append(x)
            x = block(b, x)
        feats.append(last(x))
        return feats[1:]  # drop the /2 capture

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        return self._run(self.stem(x), lambda b, v: b(v), self.last)

    def forward_bf16(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = B16.rb(self.stem.forward_bf16(B16.rb(x)))
        return self._run(x, lambda b, v: b.forward_bf16(v),
                         lambda v: B16.rb(self.last.forward_bf16(v)))


class DBFPN(nn.Module):
    """Lateral 1x1s, top-down adds, per-level 3x3 smoothing to C/4,
    concatenated at /4 (shallowest first)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 96):
        super().__init__()
        c = out_channels
        self.lateral = nn.ModuleList(nn.Conv2d(ci, c, 1, bias=False) for ci in in_channels)
        self.smooth = nn.ModuleList(nn.Conv2d(c, c // 4, 3, bias=False) for _ in in_channels)

    def _smooth(self, i, f):
        return self.smooth[i](same_pad(f, (3, 3), (1, 1)))

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        lat = [m(f) for m, f in zip(self.lateral, feats)]
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = lat[i] + upsample(lat[i + 1], 2)
        return torch.cat([upsample(self._smooth(i, f), 2 ** i) for i, f in enumerate(lat)], 1)

    def forward_bf16(self, feats: List[torch.Tensor]) -> torch.Tensor:
        lat = [B16.rb(B16.conv(m, f)) for m, f in zip(self.lateral, feats)]
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = B16.rb(lat[i] + upsample(lat[i + 1], 2))
        outs = [upsample(B16.rb(B16.conv(self.smooth[i], same_pad(f, (3, 3), (1, 1)))), 2 ** i)
                for i, f in enumerate(lat)]
        return torch.cat(outs, 1)


class DBHead(nn.Module):
    """conv3x3-bn-relu -> up2 (transposed conv, BatchNorm, relu) -> up2
    (transposed conv to 1 channel) -> sigmoid; NCHW -> [B, 1, 4H, 4W]."""

    def __init__(self, in_channels: int = 96):
        super().__init__()
        c = in_channels // 4
        self.conv = ConvBNAct(in_channels, c, (3, 3), act="relu")
        self.up1 = nn.ConvTranspose2d(c, c, 2, stride=2)
        self.bn = BatchNorm(c)
        self.up2 = nn.ConvTranspose2d(c, 1, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.up1(self.conv(x))))
        return torch.sigmoid(self.up2(x))

    def forward_bf16(self, x: torch.Tensor) -> torch.Tensor:
        x = B16.rb(self.conv.forward_bf16(x))
        x = B16.rb(B16.conv(self.up1, x)) + self.up1.bias[:, None, None]
        x = torch.relu(B16.rb(B16.batch_norm(self.bn, x)))
        x = B16.rb(B16.conv(self.up2, x)) + self.up2.bias[:, None, None]
        return B16.sigmoid(x)


class DBDetector(nn.Module):
    """Normalized NHWC images [B, H, W, 3] (H, W multiples of 32) -> DB
    probability map [B, H, W] in f32.

    ``train_outputs=True`` adds the threshold head ``head_thresh`` (the
    flax module's of the same name) and makes ``forward`` return ``(prob,
    thresh, binary)``, with ``binary = sigmoid(50 (prob - thresh))``, the
    differentiable binarization the DB loss reads (flax's module returns
    it also for ``train=True``, where it builds the threshold head too)."""

    def __init__(self, variant: str = "server", depths: Sequence[int] = (3, 4, 6, 3),
                 train_outputs: bool = False):
        super().__init__()
        if variant == "server":
            self.backbone = ResNetDet(depths)
            fpn_ch = 256
        elif variant == "mobile":
            self.backbone = MobileNetV3Det()
            fpn_ch = 96
        else:
            raise ValueError(f"unknown det variant {variant}")
        self.variant = variant
        self.fpn = DBFPN(self.backbone.out_channels, fpn_ch)
        self.head = DBHead(fpn_ch)
        self.head_thresh = DBHead(fpn_ch) if train_outputs else None
        self.bf16 = False

    def forward(self, images: torch.Tensor):
        x = images.permute(0, 3, 1, 2)
        if self.bf16:
            return self.head.forward_bf16(
                self.fpn.forward_bf16(self.backbone.forward_bf16(x)))[:, 0]
        fused = self.fpn(self.backbone(x))
        prob = self.head(fused)[:, 0]
        if self.head_thresh is None:
            return prob
        thresh = self.head_thresh(fused)[:, 0]
        return prob, thresh, torch.sigmoid(50.0 * (prob - thresh))
