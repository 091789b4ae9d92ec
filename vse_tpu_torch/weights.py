"""Weight loading for the port, without JAX or orbax.

- Rec heads: ``tools/export_torch_weights.py`` flattens a trained flax param
  tree to ``checkpoints_torch/rec_<family>_mobile.npz`` (keys joined with
  ``/``) plus its ``vse_meta.json``; ``from_jax_params`` maps that flat dict
  onto the ``CRNNRecognizer`` state dict at load. An array is f32, or, under
  the key ``bf16/<key>``, the uint16 bits of its bf16 value, which
  ``load_rec_flat`` widens back to f32 (every head but ``rec_en_mobile``
  stores its conv, dense and LSTM parameters so). A bf16-stored head loses
  nothing that the engine reads, since the engine's emulation of the
  reference's bf16 numerics (``models/bf16.py::emulate``) rounds exactly
  those arrays to bf16; its f32 ``forward`` runs on the rounded weights.
- The mobile det: ``checkpoints/ppocr_v3_det_mobile.npz`` holds paddle
  tensors, already in torch layout; ``load_det_npz`` renames the BatchNorm
  statistics.
- The server det (accurate mode, and auto on the card): the same tool writes
  ``checkpoints_torch/det_server.npz`` (bf16-stored but for BatchNorm, the
  inference head ``head_prob`` only) and ``det_server.vse_meta.json``;
  ``load_det_server`` reads it by path and ``from_jax_det`` maps it onto
  ``models.db_detector.DBDetector``.

Flax -> torch mapping: conv HWIO -> OIHW (depthwise (H, W, 1, O) -> (O, 1,
H, W)); dense (in, out) -> (out, in); BatchNorm scale/bias/mean/var ->
weight/bias/running_mean/running_var; LSTM ``OptimizedLSTMCell_0`` is the
forward direction and ``_1`` the reverse, with weight_ih = cat(ii, if, ig,
io)^T, weight_hh = cat(hi, hf, hg, ho)^T, bias_hh = the hidden biases and
bias_ih = 0 (flax's input kernels have no bias); a ``ConvTranspose``
kernel (H, W, I, O) -> (I, O, H, W) flipped in H and W, since flax's
transposed convolution correlates where torch's convolves.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DET_NPZ = os.path.join(_ROOT, "checkpoints", "ppocr_v3_det_mobile.npz")
TORCH_CKPT_DIR = os.path.join(_ROOT, "checkpoints_torch")

_GATES = ("i", "f", "g", "o")


def _conv(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))


def _bn(out: dict, dst: str, flat: dict, src: str) -> None:
    out[f"{dst}.bn.weight"] = flat[f"params/{src}/BatchNorm_0/scale"]
    out[f"{dst}.bn.bias"] = flat[f"params/{src}/BatchNorm_0/bias"]
    out[f"{dst}.bn.running_mean"] = flat[f"batch_stats/{src}/BatchNorm_0/mean"]
    out[f"{dst}.bn.running_var"] = flat[f"batch_stats/{src}/BatchNorm_0/var"]
    out[f"{dst}.bn.num_batches_tracked"] = np.zeros((), np.int64)


def _convbnact(out: dict, dst: str, flat: dict, src: str) -> None:
    out[f"{dst}.conv.weight"] = _conv(flat[f"params/{src}/Conv_0/kernel"])
    _bn(out, dst, flat, src)


def _inverted_residuals(out: dict, dst: str, flat: dict, src: str) -> None:
    """Every ``InvertedResidual_<i>`` under ``src`` onto ``<dst>.blocks.<i>``."""
    blocks = sorted(
        {int(m.group(1)) for k in flat
         for m in [re.search(rf"{src}/InvertedResidual_(\d+)/", k)] if m}
    )
    for i in blocks:
        s = f"{src}/InvertedResidual_{i}"
        d = f"{dst}.blocks.{i}"
        for part, j in (("expand", 0), ("dw", 1), ("project", 2)):
            _convbnact(out, f"{d}.{part}", flat, f"{s}/ConvBNAct_{j}")
        se = f"params/{s}/SEBlock_0"
        if f"{se}/Conv_0/kernel" in flat:
            for conv, j in (("conv1", 0), ("conv2", 1)):
                out[f"{d}.se.{conv}.weight"] = _conv(flat[f"{se}/Conv_{j}/kernel"])
                out[f"{d}.se.{conv}.bias"] = flat[f"{se}/Conv_{j}/bias"]


def _conv_transpose(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1])


def from_jax_det(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax ``DBDetector`` variables (server or mobile; the inference
    head ``head_prob``) -> ``models.db_detector.DBDetector`` state dict."""
    out: Dict[str, np.ndarray] = {}
    if any(k.startswith("params/ResNetDet_0/") for k in flat):
        bb = "ResNetDet_0"
        _convbnact(out, "backbone.stem", flat, f"{bb}/ConvBNAct_0")
        blocks = sorted({int(m.group(1)) for k in flat
                         for m in [re.search(rf"{bb}/ResNetBlock_(\d+)/", k)] if m})
        for i in blocks:
            for part, j in (("conv1", 0), ("conv2", 1), ("conv3", 2), ("shortcut", 3)):
                src = f"{bb}/ResNetBlock_{i}/ConvBNAct_{j}"
                if f"params/{src}/Conv_0/kernel" in flat:
                    _convbnact(out, f"backbone.blocks.{i}.{part}", flat, src)
    else:
        bb = "MobileNetV3Det_0"
        _convbnact(out, "backbone.stem", flat, f"{bb}/ConvBNAct_0")
        _convbnact(out, "backbone.last", flat, f"{bb}/ConvBNAct_1")
        _inverted_residuals(out, "backbone", flat, bb)
    n_levels = sum(1 for k in flat if re.match(r"params/DBFPN_0/lateral_\d+/kernel$", k))
    for i in range(n_levels):
        out[f"fpn.lateral.{i}.weight"] = _conv(flat[f"params/DBFPN_0/lateral_{i}/kernel"])
        out[f"fpn.smooth.{i}.weight"] = _conv(flat[f"params/DBFPN_0/smooth_{i}/kernel"])
    hp = "head_prob"
    _convbnact(out, "head.conv", flat, f"{hp}/ConvBNAct_0")
    for dst, j in (("head.up1", 0), ("head.up2", 1)):
        out[f"{dst}.weight"] = _conv_transpose(flat[f"params/{hp}/ConvTranspose_{j}/kernel"])
        out[f"{dst}.bias"] = flat[f"params/{hp}/ConvTranspose_{j}/bias"]
    out["head.bn.weight"] = flat[f"params/{hp}/BatchNorm_0/scale"]
    out["head.bn.bias"] = flat[f"params/{hp}/BatchNorm_0/bias"]
    out["head.bn.running_mean"] = flat[f"batch_stats/{hp}/BatchNorm_0/mean"]
    out["head.bn.running_var"] = flat[f"batch_stats/{hp}/BatchNorm_0/var"]
    out["head.bn.num_batches_tracked"] = np.zeros((), np.int64)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax CRNN variables ({"params/...", "batch_stats/..."} joined
    with "/") -> ``CRNNRecognizer`` state dict."""
    out: Dict[str, np.ndarray] = {}
    bb = "MobileNetV3Rec_0"
    _convbnact(out, "backbone.stem", flat, f"{bb}/ConvBNAct_0")
    _convbnact(out, "backbone.last", flat, f"{bb}/ConvBNAct_1")
    _inverted_residuals(out, "backbone", flat, bb)
    for layer in ("lstm1", "lstm2"):
        for cell, suffix in (("OptimizedLSTMCell_0", ""), ("OptimizedLSTMCell_1", "_reverse")):
            src = f"params/{layer}/{cell}"
            w_ih = np.concatenate([flat[f"{src}/i{g}/kernel"] for g in _GATES], axis=1)
            w_hh = np.concatenate([flat[f"{src}/h{g}/kernel"] for g in _GATES], axis=1)
            b_hh = np.concatenate([flat[f"{src}/h{g}/bias"] for g in _GATES])
            out[f"{layer}.weight_ih_l0{suffix}"] = np.ascontiguousarray(w_ih.T)
            out[f"{layer}.weight_hh_l0{suffix}"] = np.ascontiguousarray(w_hh.T)
            out[f"{layer}.bias_ih_l0{suffix}"] = np.zeros_like(b_hh)
            out[f"{layer}.bias_hh_l0{suffix}"] = b_hh
    out["ctc_fc.weight"] = np.ascontiguousarray(flat["params/ctc_fc/kernel"].T)
    out["ctc_fc.bias"] = flat["params/ctc_fc/bias"]
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def load_det_npz(path: str = DET_NPZ) -> Dict[str, torch.Tensor]:
    """Paddle det tensors -> ``PPOCRv3DetMobile`` state dict."""
    out: Dict[str, torch.Tensor] = {}
    with np.load(path) as z:
        for k in z.files:
            dst = k.replace("._mean", ".running_mean").replace(
                "._variance", ".running_var")
            out[dst] = torch.from_numpy(np.asarray(z[k], np.float32))
            if dst.endswith(".running_var"):
                out[dst[: -len("running_var")] + "num_batches_tracked"] = (
                    torch.zeros((), dtype=torch.int64))
    return out


def rec_head_paths(family: str, variant: str = "mobile") -> tuple:
    """(npz, vse_meta.json) of the family's exported rec head."""
    base = os.path.join(TORCH_CKPT_DIR, f"rec_{family}_{variant}")
    return base + ".npz", base + ".vse_meta.json"


def load_rec_meta(family: str, variant: str = "mobile") -> Optional[dict]:
    """The exported head's vse_meta.json, or None when it was not exported."""
    _, meta = rec_head_paths(family, variant)
    if not os.path.exists(meta):
        return None
    with open(meta, "r", encoding="utf-8") as f:
        return json.load(f)


BF16_PREFIX = "bf16/"


def widen_bf16(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bits -> the same values as f32."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def load_rec_flat(family: str, variant: str = "mobile") -> Dict[str, np.ndarray]:
    """The family's exported head as flat f32 arrays (bf16-stored arrays
    widened)."""
    return load_flat(rec_head_paths(family, variant)[0])


DET_SERVER_NPZ = os.path.join(TORCH_CKPT_DIR, "det_server.npz")


def load_det_server(path: str = DET_SERVER_NPZ) -> Dict[str, torch.Tensor]:
    """The exported server det -> ``DBDetector(variant="server")`` state
    dict."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no exported server det at {path}; export it with "
            "tools/export_torch_weights.py --head det_server --bf16")
    return from_jax_det(load_flat(path))


def load_flat(npz: str) -> Dict[str, np.ndarray]:
    """An exported npz as flat f32 arrays (bf16-stored arrays widened)."""
    out: Dict[str, np.ndarray] = {}
    with np.load(npz) as z:
        for k in z.files:
            if k.startswith(BF16_PREFIX):
                out[k[len(BF16_PREFIX):]] = widen_bf16(np.asarray(z[k], np.uint16))
            else:
                out[k] = np.asarray(z[k])
    return out
