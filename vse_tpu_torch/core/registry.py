"""Model resolution: (language, mode, accelerated) -> which det and rec
models run (the port's copy of ``vse_tpu/core/registry.py::resolve`` and
its ``ModelSpec``).

The reference's mode matrix (reference README_en.md:87-93,
paddle_model_config.py:50-82): fast runs the mobile det and rec; auto runs
the server models when accelerated and the mobile ones otherwise; accurate
runs the server models. Rec heads resolve per script family; the det is
shared by every language. The families of ``_MOBILE_ONLY_REC_FAMILIES``
stay on the mobile rec head unless a server head exists.

The port reads exported weights from ``models_root()`` (``$VSE_MODELS``,
else ``checkpoints_torch/``, written by ``tools/export_torch_weights.py``
or by ``train.pretrain``): ``det_server.npz`` for the server det,
``rec_<family>_<variant>.npz`` for a rec head. A training run keeps its
optimizer state in ``opt_path`` (``$VSE_OPT_DIR``, else
``~/.cache/vse_tpu_torch/opt``): a resume artifact, not a release asset.
No server rec head is exported (the JAX package has none to export), so
the engine falls back to the mobile head as the reference's engine does
(``vse_tpu/pipeline/ocr_engine.py:152-162``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from vse_tpu_torch.core.charset import script_family
from vse_tpu_torch.core.config import Mode
from vse_tpu_torch.weights import DET_NPZ, models_root, rec_head_paths


@dataclass(frozen=True)
class ModelSpec:
    """Resolved model choice for a (language, mode, accelerated) triple."""

    det_variant: str  # "mobile" | "server"
    rec_variant: str  # "mobile" | "server"
    rec_family: str  # charset / rec-head family
    det_ckpt: str
    rec_ckpt: str


# Script families whose rec heads the reference pins to the mobile model in
# every mode while no server head exists (reference
# backend/tools/paddle_model_config.py:84-91)
_MOBILE_ONLY_REC_FAMILIES = ("latin", "arabic", "cyrillic", "devanagari")


def opt_path(ckpt_base: str) -> str:
    """The optimizer sidecar's base path (``<base>.npz`` and
    ``<base>.vse_meta.json``) of the head at ``ckpt_base``."""
    root = os.environ.get("VSE_OPT_DIR",
                          os.path.expanduser("~/.cache/vse_tpu_torch/opt"))
    os.makedirs(root, exist_ok=True)
    return os.path.join(root, os.path.basename(os.path.abspath(ckpt_base)) + ".opt")


def find_opt_sidecar(ckpt_base: str) -> Optional[str]:
    """An existing sidecar of the head at ``ckpt_base``: ``opt_path``'s,
    else a ``<ckpt_base>.opt`` sibling, else None."""
    for p in (opt_path(ckpt_base), os.path.abspath(ckpt_base) + ".opt"):
        if os.path.exists(p + ".npz"):
            return p
    return None


def rec_ckpt_path(language: str, variant: str) -> str:
    """The exported rec head of the language's family (npz path)."""
    return rec_head_paths(script_family(language), variant)[0]


def det_ckpt_path(variant: str) -> str:
    """The det weights of a variant: the exported server det, or the
    converted PP-OCRv3 mobile det."""
    return os.path.join(models_root(), "det_server.npz") if variant == "server" else DET_NPZ


def resolve(language: str, mode: Mode, accelerated: bool = True) -> ModelSpec:
    family = script_family(language)
    mode = Mode(mode)
    if mode == Mode.FAST:
        det_v, rec_v = "mobile", "mobile"
    elif mode == Mode.AUTO:
        det_v, rec_v = ("server", "server") if accelerated else ("mobile", "mobile")
    else:  # ACCURATE
        det_v, rec_v = "server", "server"
    if family in _MOBILE_ONLY_REC_FAMILIES and rec_v == "server":
        if not os.path.exists(rec_ckpt_path(language, "server")):
            rec_v = "mobile"
    return ModelSpec(
        det_variant=det_v,
        rec_variant=rec_v,
        rec_family=family,
        det_ckpt=det_ckpt_path(det_v),
        rec_ckpt=rec_ckpt_path(language, rec_v),
    )
