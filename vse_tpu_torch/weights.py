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

Flax -> torch mapping: conv HWIO -> OIHW (depthwise (H, W, 1, O) -> (O, 1,
H, W)); dense (in, out) -> (out, in); BatchNorm scale/bias/mean/var ->
weight/bias/running_mean/running_var; LSTM ``OptimizedLSTMCell_0`` is the
forward direction and ``_1`` the reverse, with weight_ih = cat(ii, if, ig,
io)^T, weight_hh = cat(hi, hf, hg, ho)^T, bias_hh = the hidden biases and
bias_ih = 0 (flax's input kernels have no bias).
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


def from_jax_params(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax CRNN variables ({"params/...", "batch_stats/..."} joined
    with "/") -> ``CRNNRecognizer`` state dict."""
    out: Dict[str, np.ndarray] = {}
    bb = "MobileNetV3Rec_0"
    _convbnact(out, "backbone.stem", flat, f"{bb}/ConvBNAct_0")
    _convbnact(out, "backbone.last", flat, f"{bb}/ConvBNAct_1")
    blocks = sorted(
        {int(m.group(1)) for k in flat
         for m in [re.search(rf"{bb}/InvertedResidual_(\d+)/", k)] if m}
    )
    for i in blocks:
        src = f"{bb}/InvertedResidual_{i}"
        dst = f"backbone.blocks.{i}"
        for part, j in (("expand", 0), ("dw", 1), ("project", 2)):
            _convbnact(out, f"{dst}.{part}", flat, f"{src}/ConvBNAct_{j}")
        se = f"params/{src}/SEBlock_0"
        if f"{se}/Conv_0/kernel" in flat:
            for conv, j in (("conv1", 0), ("conv2", 1)):
                out[f"{dst}.se.{conv}.weight"] = _conv(flat[f"{se}/Conv_{j}/kernel"])
                out[f"{dst}.se.{conv}.bias"] = flat[f"{se}/Conv_{j}/bias"]
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


def rec_head_paths(family: str) -> tuple:
    """(npz, vse_meta.json) of the family's exported mobile rec head."""
    base = os.path.join(TORCH_CKPT_DIR, f"rec_{family}_mobile")
    return base + ".npz", base + ".vse_meta.json"


def load_rec_meta(family: str) -> Optional[dict]:
    """The exported head's vse_meta.json, or None when it was not exported."""
    _, meta = rec_head_paths(family)
    if not os.path.exists(meta):
        return None
    with open(meta, "r", encoding="utf-8") as f:
        return json.load(f)


BF16_PREFIX = "bf16/"


def widen_bf16(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bits -> the same values as f32."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def load_rec_flat(family: str) -> Dict[str, np.ndarray]:
    """The family's exported head as flat f32 arrays (bf16-stored arrays
    widened)."""
    npz, _ = rec_head_paths(family)
    out: Dict[str, np.ndarray] = {}
    with np.load(npz) as z:
        for k in z.files:
            if k.startswith(BF16_PREFIX):
                out[k[len(BF16_PREFIX):]] = widen_bf16(np.asarray(z[k], np.uint16))
            else:
                out[k] = np.asarray(z[k])
    return out
