"""The plain reference's models, in float32 PyTorch: the PP-OCRv3 mobile DB
detector, the DB-ResNet-50 server detector and the mobile CRNN with its
BiLSTM and CTC projection, each with a loader that reads the committed
weight files itself.

These are plain layer equations with no kernels, graphs or rounding
emulation. Padding follows the weights' origin: the paddle-converted
mobile det pads ``k // 2`` on both sides; the models trained by the
repository pad as XLA's "SAME" (the smaller half before).

``quantize_fp8`` turns a model into the benchmark's control: every
convolution, transposed convolution, dense layer and LSTM reads its
weights and its input rounded to float8 e4m3 (a scale a tensor, from its
largest magnitude), the precision below the bfloat16 the configurations
state.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0


# --- building blocks ---------------------------------------------------------


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


ACT = {"relu": F.relu, "hardswish": hard_swish, None: lambda x: x}


def same_pad(x: torch.Tensor, k, s, value: float = 0.0) -> torch.Tensor:
    """XLA "SAME" padding of NCHW ``x``: total = max((ceil(n/s)-1)*s + k - n,
    0), the smaller half before."""
    pads = []
    for n, kk, ss in ((x.shape[3], k[1], s[1]), (x.shape[2], k[0], s[0])):
        total = max((-(-n // ss) - 1) * ss + kk - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def up(x: torch.Tensor, f: int) -> torch.Tensor:
    return x if f == 1 else x.repeat_interleave(f, 2).repeat_interleave(f, 3)


class SameConvBN(nn.Module):
    """Conv ("SAME", no bias) + BatchNorm + activation."""

    def __init__(self, cin, cout, k=(3, 3), s=(1, 1), groups=1, act="relu"):
        super().__init__()
        self.k, self.s = tuple(k), tuple(s)
        self.conv = nn.Conv2d(cin, cout, self.k, self.s, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)
        self.act = ACT[act]

    def forward(self, x):
        return self.act(self.bn(self.conv(same_pad(x, self.k, self.s))))


class SE(nn.Module):
    def __init__(self, ch: int, mid: int, gate):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, mid, 1)
        self.conv2 = nn.Conv2d(mid, ch, 1)
        self.gate = gate

    def forward(self, x):
        return x * self.gate(self.conv2(F.relu(self.conv1(x.mean(dim=(2, 3), keepdim=True)))))


class InvRes(nn.Module):
    """MobileNetV3 inverted residual ("SAME" padding)."""

    def __init__(self, cin, exp, cout, k, s, use_se, act):
        super().__init__()
        self.expand = SameConvBN(cin, exp, (1, 1), act=act)
        self.dw = SameConvBN(exp, exp, (k, k), s, groups=exp, act=act)
        self.se = SE(exp, make_divisible(exp // 4),
                     lambda v: torch.clamp(v / 6.0 + 0.5, 0.0, 1.0)) if use_se else None
        self.project = SameConvBN(exp, cout, (1, 1), act=None)
        self.residual = tuple(s) == (1, 1) and cin == cout

    def forward(self, x):
        y = self.dw(self.expand(x))
        if self.se is not None:
            y = self.se(y)
        y = self.project(y)
        return x + y if self.residual else y


# --- the CRNN recognizer -------------------------------------------------------

REC_SMALL = [  # (kernel, expand, out, use_se, act, stride)
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]


class CRNN(nn.Module):
    """Normalized crops [N, 48, W, 3] -> logits [N, W // 4, classes]:
    MobileNetV3-small x``scale`` (the first stride-2 block halves both
    axes, later ones the height only), max over the height, two BiLSTMs of
    ``hidden``, a dense projection."""

    def __init__(self, classes: int, hidden: int = 48, scale: float = 0.5):
        super().__init__()
        c = make_divisible(16 * scale)
        self.stem = SameConvBN(3, c, (3, 3), (2, 2), act="hardswish")
        blocks, seen = [], 0
        for k, exp, out, se, act, stride in REC_SMALL:
            s = (1, 1)
            if stride == 2:
                s = (2, 2) if seen == 0 else (2, 1)
                seen += 1
            cout = make_divisible(out * scale)
            blocks.append(InvRes(c, make_divisible(exp * scale), cout, k, s, se, act))
            c = cout
        self.blocks = nn.ModuleList(blocks)
        self.last = SameConvBN(c, make_divisible(576 * scale), (1, 1), act="hardswish")
        feat = make_divisible(576 * scale)
        self.lstm1 = nn.LSTM(feat, hidden, batch_first=True, bidirectional=True)
        self.lstm2 = nn.LSTM(2 * hidden, hidden, batch_first=True, bidirectional=True)
        self.fc = nn.Linear(2 * hidden, classes)

    def forward(self, images):
        x = self.stem(images.permute(0, 3, 1, 2))
        for b in self.blocks:
            x = b(x)
        x = self.last(x).amax(dim=2).transpose(1, 2)
        x, _ = self.lstm1(x)
        x, _ = self.lstm2(x)
        return self.fc(x)


# --- the PP-OCRv3 mobile detector (paddle layout) -------------------------------

DET_STAGES = [  # (kernel, expand, out, stride, act), MobileNetV3-large x0.5, no SE
    [(3, 8, 8, 1, "relu"), (3, 32, 16, 2, "relu"), (3, 40, 16, 1, "relu")],
    [(5, 40, 24, 2, "relu"), (5, 64, 24, 1, "relu"), (5, 64, 24, 1, "relu")],
    [(3, 120, 40, 2, "hardswish"), (3, 104, 40, 1, "hardswish"), (3, 96, 40, 1, "hardswish"),
     (3, 96, 40, 1, "hardswish"), (3, 240, 56, 1, "hardswish"), (3, 336, 56, 1, "hardswish")],
    [(5, 336, 80, 2, "hardswish"), (5, 480, 80, 1, "hardswish"), (5, 480, 80, 1, "hardswish")],
]


class PConvBN(nn.Module):
    """Paddle conv (symmetric ``k // 2`` padding) + BatchNorm + activation."""

    def __init__(self, cin, cout, k, s=1, groups=1, act=None):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, s, padding=k // 2, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)
        self.act = ACT[act]

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class PUnit(nn.Module):
    def __init__(self, cin, exp, out, k, s, act):
        super().__init__()
        self.expand_conv = PConvBN(cin, exp, 1, act=act)
        self.bottleneck_conv = PConvBN(exp, exp, k, s, groups=exp, act=act)
        self.linear_conv = PConvBN(exp, out, 1)
        self.residual = s == 1 and cin == out

    def forward(self, x):
        y = self.linear_conv(self.bottleneck_conv(self.expand_conv(x)))
        return x + y if self.residual else y


class RSE(nn.Module):
    def __init__(self, cin, out, k):
        super().__init__()
        self.in_conv = nn.Conv2d(cin, out, k, padding=k // 2, bias=False)
        self.se_block = SE(out, out // 4, lambda v: torch.clamp(0.2 * v + 0.5, 0.0, 1.0))

    def forward(self, x):
        y = self.in_conv(x)
        return y + self.se_block(y)


class PPOCRv3Det(nn.Module):
    """Normalized NHWC canvases [B, H, W, 3] -> probability map [B, H, W]."""

    def __init__(self):
        super().__init__()
        bb = nn.Module()
        bb.conv = PConvBN(3, 8, 3, 2, act="hardswish")
        c = 8
        for si, stage in enumerate(DET_STAGES):
            units = []
            for k, exp, out, s, act in stage:
                units.append(PUnit(c, exp, out, k, s, act))
                c = out
            if si == 3:
                units.append(PConvBN(c, 480, 1, act="hardswish"))
            setattr(bb, f"stage{si}", nn.Sequential(*units))
        self.backbone = bb
        neck = nn.Module()
        neck.ins_conv = nn.ModuleList(RSE(ci, 96, 1) for ci in (16, 24, 56, 480))
        neck.inp_conv = nn.ModuleList(RSE(96, 24, 3) for _ in range(4))
        self.neck = neck
        head = nn.Module()
        b = nn.Module()
        b.conv1 = nn.Conv2d(96, 24, 3, padding=1, bias=False)
        b.conv_bn1 = nn.BatchNorm2d(24, eps=1e-5)
        b.conv2 = nn.ConvTranspose2d(24, 24, 2, stride=2)
        b.conv_bn2 = nn.BatchNorm2d(24, eps=1e-5)
        b.conv3 = nn.ConvTranspose2d(24, 1, 2, stride=2)
        head.binarize = b
        self.head = head

    def forward(self, images):
        bb, neck, b = self.backbone, self.neck, self.head.binarize
        x = bb.conv(images.permute(0, 3, 1, 2))
        feats = []
        for si in range(4):
            x = getattr(bb, f"stage{si}")(x)
            feats.append(x)
        lat = [m(f) for m, f in zip(neck.ins_conv, feats)]
        for i in range(2, -1, -1):
            lat[i] = lat[i] + up(lat[i + 1], 2)
        outs = [up(neck.inp_conv[i](f), 2 ** i) for i, f in enumerate(lat)]
        x = torch.cat(outs[::-1], dim=1)
        x = F.relu(b.conv_bn1(b.conv1(x)))
        x = F.relu(b.conv_bn2(b.conv2(x)))
        return torch.sigmoid(b.conv3(x))[:, 0]


# --- the DB-ResNet-50 server detector ------------------------------------------


class Bottleneck(nn.Module):
    def __init__(self, cin, f, s):
        super().__init__()
        self.conv1 = SameConvBN(cin, f, (1, 1))
        self.conv2 = SameConvBN(f, f, (3, 3), s)
        self.conv3 = SameConvBN(f, 4 * f, (1, 1), act=None)
        self.shortcut = (SameConvBN(cin, 4 * f, (1, 1), s, act=None)
                         if tuple(s) != (1, 1) or cin != 4 * f else None)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        return F.relu((self.shortcut(x) if self.shortcut is not None else x) + y)


class DBResNet(nn.Module):
    """Normalized NHWC canvases [B, H, W, 3] -> probability map [B, H, W]:
    ResNet-50 (7x7/2 stem, 3x3/2 max pool, bottlenecks 3-4-6-3), an FPN of
    256 with 3x3 smoothing to 64 a level, concatenated at /4, and the DB
    head (3x3 conv-BN-relu, two 2x2/2 transposed convs, sigmoid)."""

    def __init__(self, depths=(3, 4, 6, 3), fpn: int = 256):
        super().__init__()
        self.stem = SameConvBN(3, 64, (7, 7), (2, 2))
        blocks, self.ends = [], []
        cin, f = 64, 64
        for i, d in enumerate(depths):
            for j in range(d):
                blocks.append(Bottleneck(cin, f, (2, 2) if j == 0 and i > 0 else (1, 1)))
                cin = 4 * f
            self.ends.append(len(blocks) - 1)
            f *= 2
        self.blocks = nn.ModuleList(blocks)
        chans = [256 * 2 ** i for i in range(len(depths))]
        self.lateral = nn.ModuleList(nn.Conv2d(c, fpn, 1, bias=False) for c in chans)
        self.smooth = nn.ModuleList(nn.Conv2d(fpn, fpn // 4, 3, bias=False) for _ in chans)
        c = fpn // 4
        self.head_conv = SameConvBN(fpn, c, (3, 3))
        self.up1 = nn.ConvTranspose2d(c, c, 2, stride=2)
        self.bn = nn.BatchNorm2d(c, eps=1e-5)
        self.up2 = nn.ConvTranspose2d(c, 1, 2, stride=2)

    def forward(self, images):
        x = self.stem(images.permute(0, 3, 1, 2))
        x = F.max_pool2d(same_pad(x, (3, 3), (2, 2), float("-inf")), 3, 2)
        feats = []
        for i, b in enumerate(self.blocks):
            x = b(x)
            if i in self.ends:
                feats.append(x)
        lat = [m(f) for m, f in zip(self.lateral, feats)]
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = lat[i] + up(lat[i + 1], 2)
        x = torch.cat([up(self.smooth[i](same_pad(f, (3, 3), (1, 1))), 2 ** i)
                       for i, f in enumerate(lat)], 1)
        x = F.relu(self.bn(self.up1(self.head_conv(x))))
        return torch.sigmoid(self.up2(x))[:, 0]


# --- loaders -------------------------------------------------------------------


def read_npz(path: str) -> Dict[str, np.ndarray]:
    """An npz as f32 arrays; keys under ``bf16/`` hold uint16 bfloat16 bits."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            a = np.asarray(z[k])
            if k.startswith("bf16/"):
                out[k[5:]] = (a.astype(np.uint32) << 16).view(np.float32)
            else:
                out[k] = a
    return out


def _conv(k):  # flax HWIO -> torch OIHW
    return np.transpose(k, (3, 2, 0, 1))


def _conv_t(k):  # flax transposed-conv kernel (H, W, I, O) -> torch (I, O, H, W), flipped
    return np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def _cba(sd, dst, flat, src):
    sd[f"{dst}.conv.weight"] = _conv(flat[f"params/{src}/Conv_0/kernel"])
    _bn(sd, f"{dst}.bn", flat, src)


def _bn(sd, dst, flat, src):
    for a, b, col in (("weight", "scale", "params"), ("bias", "bias", "params"),
                      ("running_mean", "mean", "batch_stats"),
                      ("running_var", "var", "batch_stats")):
        sd[f"{dst}.{a}"] = flat[f"{col}/{src}/BatchNorm_0/{b}"]


def _indices(flat, pattern):
    return sorted({int(m.group(1)) for k in flat for m in [re.search(pattern, k)] if m})


def _load(model: nn.Module, sd: Dict[str, np.ndarray]) -> nn.Module:
    own = model.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"weights lack {missing[:5]}")
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(sd[k], np.float32))
                           if k in sd else own[k] for k in own})
    return model.eval()


def load_crnn(path: str, classes: int, hidden: int = 48, scale: float = 0.5) -> CRNN:
    flat = read_npz(path)
    sd: Dict[str, np.ndarray] = {}
    bb = "MobileNetV3Rec_0"
    _cba(sd, "stem", flat, f"{bb}/ConvBNAct_0")
    _cba(sd, "last", flat, f"{bb}/ConvBNAct_1")
    for i in _indices(flat, rf"{bb}/InvertedResidual_(\d+)/"):
        s = f"{bb}/InvertedResidual_{i}"
        for part, j in (("expand", 0), ("dw", 1), ("project", 2)):
            _cba(sd, f"blocks.{i}.{part}", flat, f"{s}/ConvBNAct_{j}")
        for conv, j in (("conv1", 0), ("conv2", 1)):
            key = f"params/{s}/SEBlock_0/Conv_{j}"
            if f"{key}/kernel" in flat:
                sd[f"blocks.{i}.se.{conv}.weight"] = _conv(flat[f"{key}/kernel"])
                sd[f"blocks.{i}.se.{conv}.bias"] = flat[f"{key}/bias"]
    for layer in ("lstm1", "lstm2"):
        for cell, suf in (("OptimizedLSTMCell_0", ""), ("OptimizedLSTMCell_1", "_reverse")):
            src = f"params/{layer}/{cell}"
            sd[f"{layer}.weight_ih_l0{suf}"] = np.concatenate(
                [flat[f"{src}/i{g}/kernel"] for g in "ifgo"], 1).T
            sd[f"{layer}.weight_hh_l0{suf}"] = np.concatenate(
                [flat[f"{src}/h{g}/kernel"] for g in "ifgo"], 1).T
            b = np.concatenate([flat[f"{src}/h{g}/bias"] for g in "ifgo"])
            sd[f"{layer}.bias_hh_l0{suf}"] = b
            sd[f"{layer}.bias_ih_l0{suf}"] = np.zeros_like(b)
    sd["fc.weight"] = flat["params/ctc_fc/kernel"].T
    sd["fc.bias"] = flat["params/ctc_fc/bias"]
    return _load(CRNN(classes, hidden, scale), sd)


def load_ppocr_det(path: str) -> PPOCRv3Det:
    sd = {}
    with np.load(path) as z:
        for k in z.files:
            sd[k.replace("._mean", ".running_mean").replace("._variance", ".running_var")] = \
                np.asarray(z[k], np.float32)
    return _load(PPOCRv3Det(), sd)


def load_db_resnet(path: str) -> DBResNet:
    flat = read_npz(path)
    sd: Dict[str, np.ndarray] = {}
    bb = "ResNetDet_0"
    _cba(sd, "stem", flat, f"{bb}/ConvBNAct_0")
    for i in _indices(flat, rf"{bb}/ResNetBlock_(\d+)/"):
        for part, j in (("conv1", 0), ("conv2", 1), ("conv3", 2), ("shortcut", 3)):
            src = f"{bb}/ResNetBlock_{i}/ConvBNAct_{j}"
            if f"params/{src}/Conv_0/kernel" in flat:
                _cba(sd, f"blocks.{i}.{part}", flat, src)
    for i in _indices(flat, r"params/DBFPN_0/lateral_(\d+)/kernel$"):
        sd[f"lateral.{i}.weight"] = _conv(flat[f"params/DBFPN_0/lateral_{i}/kernel"])
        sd[f"smooth.{i}.weight"] = _conv(flat[f"params/DBFPN_0/smooth_{i}/kernel"])
    _cba(sd, "head_conv", flat, "head_prob/ConvBNAct_0")
    for name, j in (("up1", 0), ("up2", 1)):
        sd[f"{name}.weight"] = _conv_t(flat[f"params/head_prob/ConvTranspose_{j}/kernel"])
        sd[f"{name}.bias"] = flat[f"params/head_prob/ConvTranspose_{j}/bias"]
    _bn(sd, "bn", flat, "head_prob")
    return _load(DBResNet(), sd)


# --- the control's precision ----------------------------------------------------


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), returned in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def quantize_fp8(model: nn.Module) -> nn.Module:
    """Round the weights of every conv, transposed conv, dense layer and
    LSTM of ``model`` to fp8 in place, and the input of each on every call."""
    kinds = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, nn.LSTM)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, kinds):
                for name, p in m.named_parameters():
                    if "weight" in name:
                        p.copy_(fp8(p))
                m.register_forward_pre_hook(lambda _m, args: (fp8(args[0]),) + tuple(args[1:]))
    return model


def layers_of(model: nn.Module) -> List[nn.Module]:
    return [m for m in model.modules() if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d,
                                                         nn.Linear, nn.LSTM))]
