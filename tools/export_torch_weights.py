"""Export a trained flax rec head for the PyTorch port.

Reads ``checkpoints/<head>`` (orbax) through ``vse_tpu.core.registry`` and
writes, for ``vse_tpu_torch``, which reads neither orbax nor flax:

  checkpoints_torch/<head>.npz            the flax variables flattened to
                                          numpy, keys joined with "/", f32
  checkpoints_torch/<head>.vse_meta.json  a copy of the head's vse_meta.json

With ``--bf16`` the conv, dense and LSTM kernels and biases (every
``params/`` array outside a BatchNorm) are stored as the bits of their
round-to-nearest-even bf16 values (uint16) under the key ``bf16/<key>``;
BatchNorm scales, biases and statistics stay f32. The JAX engine computes
the CRNN in bf16 and casts exactly those arrays to bf16 at each call, and
the port's emulation (``vse_tpu_torch.models.bf16.emulate``) rounds exactly
those, so nothing the engine reads is lost, at under half the size
(``rec_ch_mobile``: its 21,060-class projection is 2.02 M of 2.49 M
parameters).

The port maps the arrays onto its CRNN at load
(``vse_tpu_torch.weights.from_jax_params``). Runs on the CPU with JAX:

    JAX_PLATFORMS=cpu python tools/export_torch_weights.py [--head rec_en_mobile]
    JAX_PLATFORMS=cpu python tools/export_torch_weights.py --head rec_ch_mobile --bf16

Every head but en's is exported the bf16 way: ch and the ten non-CJK
families (``rec_<family>_mobile`` for latin, cyrillic, devanagari, arabic,
korean, el, ta, te, ka and th, 0.84-0.87 MB each).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def bf16_bits(a):
    """uint16 bits of the f32 array ``a`` rounded to the nearest bf16, ties
    to even (the rounding of ``torch.Tensor.to(torch.bfloat16)``)."""
    import numpy as np

    if np.isnan(a).any():
        raise ValueError("NaN in the weights")
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def stored_in_bf16(key: str) -> bool:
    """The arrays the emulation rounds: conv, dense and LSTM parameters."""
    return key.startswith("params/") and "/BatchNorm_" not in key


def export(head: str, out_dir: str, bf16: bool = False) -> str:
    import jax.numpy as jnp
    import numpy as np
    from flax.traverse_util import flatten_dict

    from vse_tpu.core.registry import init_or_load, load_meta, models_root
    from vse_tpu.models.crnn import CRNNRecognizer

    ckpt = os.path.join(models_root(), head)
    meta = load_meta(ckpt)
    if meta is None:
        raise SystemExit(f"{ckpt} has no vse_meta.json")
    variant = meta.get("variant", "mobile")
    model = CRNNRecognizer(
        vocab_size=int(meta["vocab_size"]), variant=variant,
        hidden=int(meta.get("hidden", 0) or 0),
        cnn_scale=float(meta.get("cnn_scale", 0.0) or 0.0),
    )
    variables, loaded = init_or_load(model, jnp.zeros((1, 48, 320, 3)), ckpt)
    if not loaded:
        raise SystemExit(f"could not restore {ckpt}")
    flat = {
        "/".join(k): np.asarray(v, np.float32)
        for k, v in flatten_dict(variables).items()
    }
    if bf16:
        flat = {(f"bf16/{k}" if stored_in_bf16(k) else k):
                (bf16_bits(v) if stored_in_bf16(k) else v) for k, v in flat.items()}
    os.makedirs(out_dir, exist_ok=True)
    npz = os.path.join(out_dir, f"{head}.npz")
    np.savez_compressed(npz, **flat)
    with open(os.path.join(out_dir, f"{head}.vse_meta.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f, sort_keys=True)
        f.write("\n")
    return npz


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--head", default="rec_en_mobile")
    ap.add_argument("--out", default=os.path.join(ROOT, "checkpoints_torch"))
    ap.add_argument("--bf16", action="store_true",
                    help="store the conv, dense and LSTM parameters as bf16 bits")
    args = ap.parse_args()
    path = export(args.head, args.out, args.bf16)
    print(f"{path}: {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
