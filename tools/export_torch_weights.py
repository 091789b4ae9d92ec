"""Export a trained flax rec head, or the server det, for the PyTorch port.

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

``--head det_server`` exports the server DB detector
(``vse_tpu.models.db_detector.DBDetector(variant="server")``, ResNet-50 and
FPN 256) the same way:

    JAX_PLATFORMS=cpu python tools/export_torch_weights.py --head det_server --bf16

Its orbax checkpoint holds the training head ``head_thresh`` too, and its
arrays were saved from a TPU; it is restored into the abstract variables of
the training-output model placed on the CPU, and only what inference reads
is written (``head_prob``, not ``head_thresh``). The npz is compressed when
that saves at least 5%.
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


def restore_det_server(ckpt: str) -> dict:
    """The server det's inference variables ({"params", "batch_stats"},
    ``head_thresh`` dropped), restored on the CPU."""
    import jax
    import jax.numpy as jnp

    from vse_tpu.core.registry import load_params
    from vse_tpu.models.db_detector import DBDetector

    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    abstract = jax.eval_shape(DBDetector(variant="server", train_outputs=True).init,
                              jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    like = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=cpu), abstract)
    variables = load_params(ckpt, like=like)
    return {col: {k: v for k, v in tree.items() if k != "head_thresh"}
            for col, tree in variables.items()}


def save_npz(path: str, flat: dict) -> None:
    """``np.savez_compressed`` when it saves at least 5%, else ``np.savez``."""
    import io

    import numpy as np

    packed = io.BytesIO()
    np.savez_compressed(packed, **flat)
    plain = sum(v.nbytes for v in flat.values())
    with open(path, "wb") as f:
        if packed.tell() <= 0.95 * plain:
            f.write(packed.getvalue())
        else:
            np.savez(f, **flat)


def export(head: str, out_dir: str, bf16: bool = False) -> str:
    import jax.numpy as jnp

    from vse_tpu.core.registry import init_or_load, load_meta, models_root
    from vse_tpu.models.crnn import CRNNRecognizer

    ckpt = os.path.join(models_root(), head)
    meta = load_meta(ckpt)
    if meta is None:
        raise SystemExit(f"{ckpt} has no vse_meta.json")
    if head == "det_server":
        variables = restore_det_server(ckpt)
        return write(head, out_dir, variables, meta, bf16)
    variant = meta.get("variant", "mobile")
    model = CRNNRecognizer(
        vocab_size=int(meta["vocab_size"]), variant=variant,
        hidden=int(meta.get("hidden", 0) or 0),
        cnn_scale=float(meta.get("cnn_scale", 0.0) or 0.0),
    )
    variables, loaded = init_or_load(model, jnp.zeros((1, 48, 320, 3)), ckpt)
    if not loaded:
        raise SystemExit(f"could not restore {ckpt}")
    return write(head, out_dir, variables, meta, bf16)


def write(head: str, out_dir: str, variables, meta: dict, bf16: bool) -> str:
    """The flattened variables as ``<head>.npz`` and the meta beside it."""
    import numpy as np
    from flax.traverse_util import flatten_dict

    flat = {
        "/".join(k): np.asarray(v, np.float32)
        for k, v in flatten_dict(variables).items()
    }
    if bf16:
        flat = {(f"bf16/{k}" if stored_in_bf16(k) else k):
                (bf16_bits(v) if stored_in_bf16(k) else v) for k, v in flat.items()}
    os.makedirs(out_dir, exist_ok=True)
    npz = os.path.join(out_dir, f"{head}.npz")
    save_npz(npz, flat)
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
