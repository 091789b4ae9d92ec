"""Parity of the port's models and weight mapping with the flax modules.

Both sides run in float32 (the flax modules are built with
``dtype=jnp.float32``) on the same numpy inputs. Tolerances: CRNN logits
atol 2e-4 and det probabilities atol 1e-5 (f32 convolutions summed in
another order); the weight mapping is bit-exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from vse_tpu.models.crnn import CRNNRecognizer as FlaxCRNN
from vse_tpu.models.ppocr_det import PPOCRv3DetMobile as FlaxDet
from vse_tpu.models.ppocr_det import load_ppocr_det_weights
from vse_tpu_torch.models.common import same_pad
from vse_tpu_torch.models.crnn import CRNNRecognizer
from vse_tpu_torch.models.ppocr_det import PPOCRv3DetMobile
from vse_tpu_torch.weights import DET_NPZ, from_jax_params, load_det_npz, load_rec_flat


def flax_crnn_variables(vocab, width, seed, hidden=0, cnn_scale=0.0):
    """Freshly initialised flax CRNN variables with non-trivial BatchNorm
    statistics, flattened to {"params/...": array}."""
    model = FlaxCRNN(vocab_size=vocab, hidden=hidden, cnn_scale=cnn_scale,
                     dtype=jnp.float32)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 48, width, 3)))
    rng = np.random.default_rng(seed)
    flat = {"/".join(k): np.asarray(a) for k, a in flatten_dict(v).items()}
    for k in flat:
        if k.endswith("/mean"):
            flat[k] = (rng.standard_normal(flat[k].shape) * 0.1).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    return model, flat


def flax_apply(model, flat, x):
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(a) for k, a in flat.items()})
    return np.asarray(jax.jit(model.apply)(tree, jnp.asarray(x)))


def torch_crnn(flat, vocab, **kw):
    m = CRNNRecognizer(vocab, **kw)
    m.load_state_dict(from_jax_params(flat), strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def fresh_crnn():
    """Random-init flax params: the exact function the exported heads go
    through, shared by the logits and round-trip tests."""
    return flax_crnn_variables(68, 320, seed=3)


def check_crnn_logits(model, flat, width, **kw):
    x = np.random.default_rng(1).standard_normal((3, 48, width, 3)).astype(np.float32)
    ref = flax_apply(model, flat, x)
    with torch.no_grad():
        got = torch_crnn(flat, 68, **kw)(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, width // 4, 69)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


def test_crnn_logits_match_flax_fresh_init(fresh_crnn):
    check_crnn_logits(*fresh_crnn, 320)


def test_crnn_logits_match_flax_with_meta_overrides():
    """An odd sequence width (SAME padding) and the hidden / cnn_scale
    overrides a head's vse_meta.json may record."""
    model, flat = flax_crnn_variables(68, 100, seed=100, hidden=32, cnn_scale=0.75)
    check_crnn_logits(model, flat, 100, hidden=32, cnn_scale=0.75)


def test_crnn_logits_match_flax_on_exported_en_head():
    flat = load_rec_flat("en")
    model = FlaxCRNN(vocab_size=68, dtype=jnp.float32)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 48, 320, 3)).astype(np.float32)
    ref = flax_apply(model, flat, x)
    with torch.no_grad():
        got = torch_crnn(flat, 68)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_from_jax_params_round_trips_every_tensor_bit_exact(fresh_crnn):
    _, flat = fresh_crnn
    sd = from_jax_params(flat)
    used = set()

    def conv_back(t):  # OIHW -> HWIO
        return t.numpy().transpose(2, 3, 1, 0)

    for k, a in flat.items():
        coll, *path = k.split("/")
        if path[0] == "MobileNetV3Rec_0":
            rest = path[1:]
            if rest[0].startswith("InvertedResidual_"):
                i = int(rest[0].split("_")[1])
                if rest[1] == "SEBlock_0":
                    conv = {"Conv_0": "conv1", "Conv_1": "conv2"}[rest[2]]
                    key = f"backbone.blocks.{i}.se.{conv}.{'weight' if rest[3] == 'kernel' else 'bias'}"
                    back = conv_back(sd[key]) if rest[3] == "kernel" else sd[key].numpy()
                    used.add(key)
                    np.testing.assert_array_equal(back, a)
                    continue
                part = {"ConvBNAct_0": "expand", "ConvBNAct_1": "dw", "ConvBNAct_2": "project"}[rest[1]]
                prefix, leaf = f"backbone.blocks.{i}.{part}", rest[2:]
            else:
                part = {"ConvBNAct_0": "stem", "ConvBNAct_1": "last"}[rest[0]]
                prefix, leaf = f"backbone.{part}", rest[1:]
            if leaf[0] == "Conv_0":
                key = f"{prefix}.conv.weight"
                back = conv_back(sd[key])
            else:
                name = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                        "var": "running_var"}[leaf[1]]
                key = f"{prefix}.bn.{name}"
                back = sd[key].numpy()
            used.add(key)
            np.testing.assert_array_equal(back, a)
        elif path[0] == "ctc_fc":
            key = f"ctc_fc.{'weight' if path[1] == 'kernel' else 'bias'}"
            back = sd[key].numpy().T if path[1] == "kernel" else sd[key].numpy()
            used.add(key)
            np.testing.assert_array_equal(back, a)
        else:  # lstmN/OptimizedLSTMCell_{0,1}/{ii..io,hi..ho}/{kernel,bias}
            layer, cell, dense, leaf = path
            suffix = "" if cell.endswith("_0") else "_reverse"
            gate = "ifgo".index(dense[1])
            hid = sd[f"{layer}.weight_hh_l0{suffix}"].shape[1]
            rows = slice(gate * hid, (gate + 1) * hid)
            if leaf == "bias":
                key = f"{layer}.bias_hh_l0{suffix}"
                back = sd[key].numpy()[rows]
            else:
                key = f"{layer}.weight_{'ih' if dense[0] == 'i' else 'hh'}_l0{suffix}"
                back = sd[key].numpy()[rows].T
            used.add(key)
            np.testing.assert_array_equal(back, a)
    for k, t in sd.items():  # what no flax tensor maps to is zero by construction
        if k not in used:
            assert k.endswith(("num_batches_tracked", "bias_ih_l0", "bias_ih_l0_reverse")), k
            assert not t.any()


def test_det_prob_map_matches_flax_on_real_weights():
    w = dict(np.load(DET_NPZ))
    flax_vars = load_ppocr_det_weights(w)
    det = PPOCRv3DetMobile()
    det.load_state_dict(load_det_npz(), strict=True)
    det.eval()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 96, 160, 3)).astype(np.float32)
    x[:, 40:60, 20:140] = 2.0  # a bright bar the detector responds to
    ref = np.asarray(jax.jit(FlaxDet(dtype=jnp.float32).apply)(flax_vars, jnp.asarray(x)))
    with torch.no_grad():
        got = det(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 96, 160)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,k,s", [(48, 3, 2), (47, 3, 2), (48, 5, 2), (12, 5, 1), (7, 3, 2)])
def test_same_pad_matches_xla(n, k, s):
    x = torch.arange(n, dtype=torch.float32).reshape(1, 1, 1, n).expand(1, 1, n, n)
    padded = same_pad(x, (k, k), (s, s))
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    assert padded.shape[-1] == n + total
    assert (padded.shape[-1] - k) // s + 1 == out
    lo = total // 2
    assert torch.equal(padded[0, 0, lo, lo : lo + n], x[0, 0, 0])
