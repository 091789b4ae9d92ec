"""The server DB detector (``vse_tpu_torch/models/db_detector.py``) against
the JAX package's flax modules (``vse_tpu/models/db_detector.py``), on the
CPU, and its exported weights.

- Architecture, f32: ``ResNetDet(depths=(1, 1, 1, 1))`` + ``DBFPN`` +
  ``DBHead`` with random parameters and BatchNorm statistics, and the
  mobile variant, against flax in f32: prob maps within 1e-4 (f32 sums in
  another order).
- bf16 numerics: the same small model with ``forward_bf16`` against the
  flax module built with ``dtype=bfloat16`` and jitted, as the JAX engine
  runs it: within 0.01, and within 1e-3 on average (XLA's CPU convolutions
  sum in another order, which flips a bf16 rounding here and there, and a
  flip of one bf16 step of a logit near 0 moves the sigmoid by up to 0.002
  per flipped layer; ROADMAP fault 11). On the real weights below, 74% of
  the probe's values are equal.
- The real ``det_server`` weights on a [1, 64, 320] crop of the keyframe
  clip against the JAX package's prob map committed in
  ``assets/smoke/det_server_probe.npz``: within 0.03 (fault 11 again; the
  measured difference is 0.0115), and the boxes of both maps' postprocess
  within 2 px with equal valid masks.
- The bf16 export is lossless through the emulation: the model built from
  the orbax checkpoint and the one built from the npz have bit-equal state
  dicts once both are emulated.
"""

import os

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from _torch_helpers import two_threads  # noqa: F401
from vse_tpu.models import db_detector as jdb
from vse_tpu_torch.models import bf16 as B16
from vse_tpu_torch.models.db_detector import DBDetector, DBFPN, DBHead, max_pool_same
from vse_tpu_torch.ops.db_postprocess import db_postprocess
from vse_tpu_torch.video.synth import SMOKE_FIXTURE
from vse_tpu_torch.weights import DET_SERVER_NPZ, from_jax_det, load_det_server, load_flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SmallServer(nn.Module):
    """The flax server det with one block a stage and a narrower FPN, under
    the JAX ``DBDetector``'s module names."""

    fpn: int = 64
    dtype: object = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = x.astype(self.dtype)
        f = jdb.ResNetDet(depths=(1, 1, 1, 1), dtype=self.dtype, name="ResNetDet_0")(x)
        y = jdb.DBFPN(out_channels=self.fpn, dtype=self.dtype, name="DBFPN_0")(f)
        return jdb.DBHead(in_channels=self.fpn, dtype=self.dtype, name="head_prob")(y)[..., 0]


def random_variables(module, x, seed):
    """Random parameters in the shapes of ``module``'s (read with
    ``jax.eval_shape``, so nothing is compiled for the init): conv kernels
    scaled by their fan-in, and BatchNorm statistics drawn so that the
    activations stay in range and the prob map is not saturated."""
    rng = np.random.default_rng(seed)
    abstract = jax.eval_shape(module.init, jax.random.PRNGKey(seed), jnp.asarray(x))

    def draw(path, a):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(a.shape) / np.sqrt(np.prod(a.shape[:-1]))
        elif name == "mean":
            v = rng.uniform(-0.2, 0.2, a.shape)
        elif name in ("var", "scale"):
            v = rng.uniform(0.5, 2.0, a.shape)
        else:  # biases
            v = rng.uniform(-0.1, 0.1, a.shape)
        return jnp.asarray(v.astype(np.float32))

    return jax.tree_util.tree_map_with_path(draw, abstract)


def torch_model(variant, variables, fpn=None, depths=(1, 1, 1, 1)):
    m = DBDetector(variant, depths=depths)
    if fpn is not None:
        m.fpn = DBFPN(m.backbone.out_channels, fpn)
        m.head = DBHead(fpn)
    flat = {"/".join(k): np.asarray(a, np.float32) for k, a in flatten_dict(variables).items()}
    m.load_state_dict(from_jax_det(flat), strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def small():
    x = np.random.default_rng(0).standard_normal((2, 64, 96, 3)).astype(np.float32)
    variables = random_variables(SmallServer(), x, 1)
    return x, variables


def test_max_pool_pads_as_xla_same():
    x = np.random.default_rng(1).standard_normal((2, 9, 10, 3)).astype(np.float32) - 3.0
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_f32_architecture_matches_flax(small):
    x, variables = small
    want = np.asarray(jax.jit(SmallServer().apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = torch_model("server", variables, fpn=64)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 64, 96) and 0.01 < want.std()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_mobile_variant_matches_flax():
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(np.float32)
    flax_model = jdb.DBDetector(variant="mobile", dtype=jnp.float32)
    variables = random_variables(flax_model, x, 3)
    want = np.asarray(jax.jit(flax_model.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = torch_model("mobile", variables)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_bf16_numerics_match_jitted_flax(small):
    x, variables = small
    want = np.asarray(jax.jit(SmallServer(dtype=jnp.bfloat16).apply)(variables, jnp.asarray(x)))
    m = B16.emulate(torch_model("server", variables, fpn=64))
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.01)
    assert np.abs(got - want).mean() < 1e-3


def test_real_weights_on_the_probe_crop():
    with np.load(os.path.join(SMOKE_FIXTURE, "det_server_probe.npz")) as z:
        frames, want, boxes, valid = (np.asarray(z[k]) for k in ("frames", "prob", "boxes", "valid"))
    assert frames.shape == (1, 64, 320, 3) and valid.any()
    from vse_tpu_torch.ops.image import normalize_det

    m = DBDetector("server")
    m.load_state_dict(load_det_server())
    B16.emulate(m).eval()
    with torch.no_grad():
        got = m(normalize_det(torch.from_numpy(frames)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0.03)
    assert np.mean(got.numpy() == want) > 0.7
    b, _, v, _ = db_postprocess(got, max_boxes=8, pool=8, num_sweeps=2)
    np.testing.assert_array_equal(v.numpy(), valid)
    assert np.abs(b.numpy() - boxes).max() <= 2.0


def test_bf16_export_is_lossless_through_emulate():
    """The det built from the orbax checkpoint (restored as the export tool
    restores it) and the one built from the bf16-stored npz have bit-equal
    state dicts once both are emulated; BatchNorm arrays are stored as they
    were, and only ``head_prob`` is exported."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from export_torch_weights import restore_det_server

    variables = restore_det_server(os.path.join(ROOT, "checkpoints", "det_server"))
    orbax = {"/".join(k): np.asarray(v, np.float32) for k, v in flatten_dict(variables).items()}
    npz = load_flat(DET_SERVER_NPZ)
    assert sorted(npz) == sorted(orbax) and len(npz) == 286
    assert not any("head_thresh" in k for k in npz)
    models = []
    for flat in (orbax, npz):
        m = DBDetector("server")
        m.load_state_dict(from_jax_det(flat), strict=True)
        models.append(B16.emulate(m).state_dict())
    for k in models[0]:
        assert torch.equal(models[0][k], models[1][k]), k
    bn = [k for k in orbax if "BatchNorm_" in k]
    assert bn and all(np.array_equal(orbax[k], npz[k]) for k in bn)
    assert os.path.getsize(DET_SERVER_NPZ) < 42_000_000
