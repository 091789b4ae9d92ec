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

- Heads the port trains (``train/pretrain.py``): ``to_jax_params`` /
  ``to_jax_det``, the inverses of the two mappings (bit-exact round trips),
  flatten a state dict to the same flat flax keys, and ``save_flat`` writes
  ``<base>.npz`` and ``<base>.vse_meta.json`` under ``models_root()``
  (``$VSE_MODELS``, else ``checkpoints_torch/``), where the engine reads
  heads.

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
    for dst, hp in (("head", "head_prob"), ("head_thresh", "head_thresh")):
        if f"params/{hp}/ConvTranspose_0/kernel" not in flat:
            continue  # an inference head has no head_thresh
        _convbnact(out, f"{dst}.conv", flat, f"{hp}/ConvBNAct_0")
        for up, j in (("up1", 0), ("up2", 1)):
            out[f"{dst}.{up}.weight"] = _conv_transpose(
                flat[f"params/{hp}/ConvTranspose_{j}/kernel"])
            out[f"{dst}.{up}.bias"] = flat[f"params/{hp}/ConvTranspose_{j}/bias"]
        _bn(out, dst, flat, hp)
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


def models_root() -> str:
    """Where heads are read and trained heads written: ``$VSE_MODELS``, else
    ``checkpoints_torch/`` (``core/registry.py`` re-exports it)."""
    return os.environ.get("VSE_MODELS") or TORCH_CKPT_DIR


def rec_head_paths(family: str, variant: str = "mobile") -> tuple:
    """(npz, vse_meta.json) of the family's rec head under ``models_root()``."""
    base = os.path.join(models_root(), f"rec_{family}_{variant}")
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
    dict (the inference head only: a trained det's ``head_thresh`` is
    dropped)."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no exported server det at {path}; export it with "
            "tools/export_torch_weights.py --head det_server --bf16")
    sd = from_jax_det(load_flat(path))
    return {k: v for k, v in sd.items() if not k.startswith("head_thresh.")}


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


# --- torch -> flat flax (the inverses of the mappings above) -------------


def _conv_inv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _conv_transpose_inv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1)))


def _bn_inv(out: dict, sd: dict, src: str, dst: str) -> None:
    out[f"params/{dst}/BatchNorm_0/scale"] = sd[f"{src}.bn.weight"]
    out[f"params/{dst}/BatchNorm_0/bias"] = sd[f"{src}.bn.bias"]
    out[f"batch_stats/{dst}/BatchNorm_0/mean"] = sd[f"{src}.bn.running_mean"]
    out[f"batch_stats/{dst}/BatchNorm_0/var"] = sd[f"{src}.bn.running_var"]


def _convbnact_inv(out: dict, sd: dict, src: str, dst: str) -> None:
    out[f"params/{dst}/Conv_0/kernel"] = _conv_inv(sd[f"{src}.conv.weight"])
    _bn_inv(out, sd, src, dst)


def _indices(sd: dict, prefix: str) -> list:
    return sorted({int(m.group(1)) for k in sd
                   for m in [re.match(rf"{re.escape(prefix)}\.(\d+)\.", k)] if m})


def _inverted_residuals_inv(out: dict, sd: dict, src: str, dst: str) -> None:
    for i in _indices(sd, f"{src}.blocks"):
        s, d = f"{src}.blocks.{i}", f"{dst}/InvertedResidual_{i}"
        for part, j in (("expand", 0), ("dw", 1), ("project", 2)):
            _convbnact_inv(out, sd, f"{s}.{part}", f"{d}/ConvBNAct_{j}")
        if f"{s}.se.conv1.weight" in sd:
            for conv, j in (("conv1", 0), ("conv2", 1)):
                out[f"params/{d}/SEBlock_0/Conv_{j}/kernel"] = _conv_inv(sd[f"{s}.se.{conv}.weight"])
                out[f"params/{d}/SEBlock_0/Conv_{j}/bias"] = sd[f"{s}.se.{conv}.bias"]


def _numpy_sd(sd) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def to_jax_params(state_dict) -> Dict[str, np.ndarray]:
    """``CRNNRecognizer`` state dict -> flat flax CRNN variables, the layout
    of ``checkpoints_torch/rec_*.npz`` (the inverse of
    ``from_jax_params``; a round trip is bit-exact). ``bias_ih`` is added
    into the hidden bias where it is not zero."""
    sd = _numpy_sd(state_dict)
    out: Dict[str, np.ndarray] = {}
    bb = "MobileNetV3Rec_0"
    _convbnact_inv(out, sd, "backbone.stem", f"{bb}/ConvBNAct_0")
    _convbnact_inv(out, sd, "backbone.last", f"{bb}/ConvBNAct_1")
    _inverted_residuals_inv(out, sd, "backbone", bb)
    for layer in ("lstm1", "lstm2"):
        for cell, suffix in (("OptimizedLSTMCell_0", ""), ("OptimizedLSTMCell_1", "_reverse")):
            dst = f"params/{layer}/{cell}"
            w_ih = np.split(sd[f"{layer}.weight_ih_l0{suffix}"].T, 4, axis=1)
            w_hh = np.split(sd[f"{layer}.weight_hh_l0{suffix}"].T, 4, axis=1)
            b_ih = sd[f"{layer}.bias_ih_l0{suffix}"]
            b = sd[f"{layer}.bias_hh_l0{suffix}"]
            if b_ih.any():
                b = b + b_ih
            for g, wi, wh, bg in zip(_GATES, w_ih, w_hh, np.split(b, 4)):
                out[f"{dst}/i{g}/kernel"] = np.ascontiguousarray(wi)
                out[f"{dst}/h{g}/kernel"] = np.ascontiguousarray(wh)
                out[f"{dst}/h{g}/bias"] = bg
    out["params/ctc_fc/kernel"] = np.ascontiguousarray(sd["ctc_fc.weight"].T)
    out["params/ctc_fc/bias"] = sd["ctc_fc.bias"]
    return out


def to_jax_det(state_dict) -> Dict[str, np.ndarray]:
    """``DBDetector`` state dict (either variant, with or without
    ``head_thresh``) -> flat flax ``DBDetector`` variables (the inverse of
    ``from_jax_det``; a round trip is bit-exact)."""
    sd = _numpy_sd(state_dict)
    out: Dict[str, np.ndarray] = {}
    if "backbone.blocks.0.conv1.conv.weight" in sd:
        bb = "ResNetDet_0"
        _convbnact_inv(out, sd, "backbone.stem", f"{bb}/ConvBNAct_0")
        for i in _indices(sd, "backbone.blocks"):
            for part, j in (("conv1", 0), ("conv2", 1), ("conv3", 2), ("shortcut", 3)):
                if f"backbone.blocks.{i}.{part}.conv.weight" in sd:
                    _convbnact_inv(out, sd, f"backbone.blocks.{i}.{part}",
                                   f"{bb}/ResNetBlock_{i}/ConvBNAct_{j}")
    else:
        bb = "MobileNetV3Det_0"
        _convbnact_inv(out, sd, "backbone.stem", f"{bb}/ConvBNAct_0")
        _convbnact_inv(out, sd, "backbone.last", f"{bb}/ConvBNAct_1")
        _inverted_residuals_inv(out, sd, "backbone", bb)
    for i in _indices(sd, "fpn.lateral"):
        out[f"params/DBFPN_0/lateral_{i}/kernel"] = _conv_inv(sd[f"fpn.lateral.{i}.weight"])
        out[f"params/DBFPN_0/smooth_{i}/kernel"] = _conv_inv(sd[f"fpn.smooth.{i}.weight"])
    for src, hp in (("head", "head_prob"), ("head_thresh", "head_thresh")):
        if f"{src}.up1.weight" not in sd:
            continue
        _convbnact_inv(out, sd, f"{src}.conv", f"{hp}/ConvBNAct_0")
        for up, j in (("up1", 0), ("up2", 1)):
            out[f"params/{hp}/ConvTranspose_{j}/kernel"] = _conv_transpose_inv(sd[f"{src}.{up}.weight"])
            out[f"params/{hp}/ConvTranspose_{j}/bias"] = sd[f"{src}.{up}.bias"]
        _bn_inv(out, sd, src, hp)
    return out


def save_flat(flat: Dict[str, np.ndarray], base: str, meta: Optional[dict] = None) -> None:
    """Write ``<base>.npz`` (f32 arrays under their flat keys) and, with
    ``meta``, ``<base>.vse_meta.json``; each through a temporary file and a
    rename, so a kill mid-save leaves the previous files whole. The npz is
    written before the meta, whose step a resume trusts."""
    os.makedirs(os.path.dirname(os.path.abspath(base)) or ".", exist_ok=True)
    tmp = base + ".npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in flat.items()})
    os.replace(tmp, base + ".npz")
    if meta is not None:
        tmp = base + ".vse_meta.json.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(meta, f)
        os.replace(tmp, base + ".vse_meta.json")


def load_meta(base: str) -> Optional[dict]:
    """``<base>.vse_meta.json``, or None when it is missing or unreadable."""
    try:
        with open(base + ".vse_meta.json", "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
