"""The port's emulation of the reference's bf16 numerics
(``vse_tpu_torch/models/bf16.py``) against the flax modules built as the JAX
engine builds them (``dtype=jnp.bfloat16``, f32 parameters), jitted on the
CPU, on the same numpy inputs.

Tolerances: the det probability map within 1e-6 (f32 rounding of the final
sigmoid; the f32 port is off by more than 1e-2 on the same input); one
bidirectional LSTM within 1e-6; the CRNN on the exported en head with the
same argmax everywhere, at least 3/4 of the logits bit-equal and a mean
absolute difference under 0.01 (convolution sums in another order flip a
bf16 rounding now and then, and the LSTM carries the flips along; the f32
port's mean difference is 0.037). ``fma`` is held against numpy's f64.
"""

import numpy as np
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from vse_tpu.models.crnn import BiLSTM as FlaxBiLSTM
from vse_tpu.models.crnn import CRNNRecognizer as FlaxCRNN
from vse_tpu.models.ppocr_det import PPOCRv3DetMobile as FlaxDet
from vse_tpu.models.ppocr_det import load_ppocr_det_weights
from vse_tpu_torch.models import bf16 as B16
from vse_tpu_torch.models.crnn import CRNNRecognizer
from vse_tpu_torch.models.ppocr_det import PPOCRv3DetMobile
from vse_tpu_torch.weights import DET_NPZ, from_jax_params, load_det_npz, load_rec_flat


def port_det(bf16: bool) -> PPOCRv3DetMobile:
    det = PPOCRv3DetMobile()
    det.load_state_dict(load_det_npz(), strict=True)
    return (B16.emulate(det) if bf16 else det).eval()


def test_det_bf16_matches_flax_bf16_on_real_weights():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 96, 160, 3)).astype(np.float32)
    x[:, 40:60, 20:140] = 2.0  # a bright bar the detector responds to
    flax_vars = load_ppocr_det_weights(dict(np.load(DET_NPZ)))
    ref = np.asarray(jax.jit(FlaxDet().apply)(flax_vars, jnp.asarray(x)))
    with torch.no_grad():
        got = port_det(True)(torch.from_numpy(x)).numpy()
        f32 = port_det(False)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert np.abs(f32 - ref).max() > 1e-2


def test_crnn_bf16_matches_flax_bf16_on_exported_en_head():
    flat = load_rec_flat("en")
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(a) for k, a in flat.items()})
    x = np.random.default_rng(2).uniform(-1, 1, (2, 48, 320, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(FlaxCRNN(vocab_size=68).apply)(tree, jnp.asarray(x)))
    m = CRNNRecognizer(68)
    m.load_state_dict(from_jax_params(flat), strict=True)
    with torch.no_grad():
        got = B16.emulate(m).eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
    d = np.abs(got - ref)
    assert (d == 0).mean() >= 0.75
    assert d.mean() < 0.01


def test_bilstm_bf16_matches_flax_bilstm():
    x = np.random.default_rng(5).standard_normal((3, 20, 16)).astype(np.float32)
    flax_lstm = FlaxBiLSTM(48)
    xb = jnp.asarray(x, jnp.bfloat16)
    variables = flax_lstm.init(jax.random.PRNGKey(1), xb)
    ref = np.asarray(jax.jit(flax_lstm.apply)(variables, xb))
    fl = {"/".join(k): np.asarray(a) for k, a in flatten_dict(variables["params"]).items()}
    lstm = nn.LSTM(16, 48, batch_first=True, bidirectional=True)
    sd = {}
    for cell, suffix in (("OptimizedLSTMCell_0", ""), ("OptimizedLSTMCell_1", "_reverse")):
        w_ih = np.concatenate([fl[f"{cell}/i{g}/kernel"] for g in "ifgo"], 1)
        w_hh = np.concatenate([fl[f"{cell}/h{g}/kernel"] for g in "ifgo"], 1)
        b_hh = np.concatenate([fl[f"{cell}/h{g}/bias"] for g in "ifgo"])
        sd[f"weight_ih_l0{suffix}"] = torch.from_numpy(w_ih.T.copy())
        sd[f"weight_hh_l0{suffix}"] = torch.from_numpy(w_hh.T.copy())
        sd[f"bias_hh_l0{suffix}"] = torch.from_numpy(b_hh)
        sd[f"bias_ih_l0{suffix}"] = torch.zeros(b_hh.shape)
    lstm.load_state_dict(sd)
    B16.emulate(lstm)
    with torch.no_grad():
        got = B16.bilstm(lstm, B16.rb(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_emulate_rounds_weights_and_keeps_batchnorm_f32():
    bf, f32 = port_det(True), port_det(False)
    w = bf.backbone.conv.conv.weight
    assert torch.equal(w, B16.rb(f32.backbone.conv.conv.weight))
    assert not torch.equal(w, f32.backbone.conv.conv.weight)
    for name in ("weight", "bias", "running_mean", "running_var"):
        assert torch.equal(getattr(bf.backbone.conv.bn, name), getattr(f32.backbone.conv.bn, name))


def test_fma_rounds_once():
    rng = np.random.default_rng(9)
    a, b, c = (rng.standard_normal(10000).astype(np.float32) for _ in range(3))
    want = (a.astype(np.float64) * b + c).astype(np.float32)
    got = B16.fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != a * b + c).any()  # two roundings differ somewhere
