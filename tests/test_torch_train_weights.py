"""Weights in both directions (``vse_tpu_torch/weights.py``) and the
registry's training paths (``core/registry.py``): round trips are bit-exact,
a port state dict becomes the flat flax layout of ``checkpoints_torch/`` and
loads into the JAX CRNN, and heads and optimizer sidecars land where the
engine and a resume look for them."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict

from vse_tpu.models.crnn import CRNNRecognizer as JaxCRNN
from vse_tpu_torch import weights as W
from vse_tpu_torch.core import registry
from vse_tpu_torch.models.crnn import CRNNRecognizer
from vse_tpu_torch.models.db_detector import DBDetector
from vse_tpu_torch.train.pretrain import flax_init


def same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        and np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def test_rec_head_round_trips_bit_exact():
    flat = W.load_flat(os.path.join(W.TORCH_CKPT_DIR, "rec_en_mobile.npz"))
    assert same(W.to_jax_params(W.from_jax_params(flat)), flat)
    sd = flax_init(CRNNRecognizer(68, variant="server"), 3).state_dict()
    back = W.from_jax_params(W.to_jax_params(sd))
    assert same({k: v.numpy() for k, v in back.items() if "num_batches" not in k},
                {k: v.numpy() for k, v in sd.items() if "num_batches" not in k})


@pytest.mark.parametrize("variant", ["mobile", "server"])
def test_det_round_trips_bit_exact_with_the_threshold_head(variant):
    sd = flax_init(DBDetector(variant, train_outputs=True), 1).state_dict()
    flat = W.to_jax_det(sd)
    assert any(k.startswith("params/head_thresh/") for k in flat)
    assert same(W.to_jax_det(W.from_jax_det(flat)), flat)
    back = W.from_jax_det(flat)
    assert same({k: v.numpy() for k, v in back.items() if "num_batches" not in k},
                {k: v.numpy() for k, v in sd.items() if "num_batches" not in k})


def test_exported_server_det_round_trips_and_drops_no_key():
    flat = W.load_flat(W.DET_SERVER_NPZ)
    assert same(W.to_jax_det(W.from_jax_det(flat)), flat)


def test_lstm_input_bias_folds_into_the_hidden_bias():
    m = CRNNRecognizer(68)
    with torch.no_grad():
        m.lstm1.bias_ih_l0.fill_(0.25)
    flat = W.to_jax_params(m.state_dict())
    want = (m.lstm1.bias_hh_l0 + 0.25).detach().numpy()
    got = np.concatenate([flat[f"params/lstm1/OptimizedLSTMCell_0/h{g}/bias"] for g in "ifgo"])
    np.testing.assert_array_equal(got, want)


def test_a_port_head_loads_into_the_jax_crnn():
    """A port state dict, flattened by ``to_jax_params``, is the flax CRNN's
    variables: its eval forward equals the port's (f32, within 1e-4)."""
    m = flax_init(CRNNRecognizer(68), 7)
    m.train()
    x = torch.randn(4, 48, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        m(x)  # move the running statistics off their init
    m.eval()
    with torch.no_grad():
        got = m(x[:2]).numpy()
    variables = unflatten_dict({tuple(k.split("/")): v
                                for k, v in W.to_jax_params(m.state_dict()).items()})
    want = jax.jit(JaxCRNN(vocab_size=68, dtype=jnp.float32).apply)(variables, x[:2].numpy())
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def test_models_root_and_head_paths_follow_vse_models(monkeypatch, tmp_path):
    monkeypatch.delenv("VSE_MODELS", raising=False)
    assert registry.models_root() == W.TORCH_CKPT_DIR
    assert registry.rec_ckpt_path("en", "mobile") == os.path.join(
        W.TORCH_CKPT_DIR, "rec_en_mobile.npz")
    assert registry.resolve("en", "accurate").det_ckpt == W.DET_SERVER_NPZ
    monkeypatch.setenv("VSE_MODELS", str(tmp_path))
    assert registry.models_root() == str(tmp_path)
    assert W.rec_head_paths("latin") == (str(tmp_path / "rec_latin_mobile.npz"),
                                         str(tmp_path / "rec_latin_mobile.vse_meta.json"))
    assert registry.rec_ckpt_path("fr", "mobile") == str(tmp_path / "rec_latin_mobile.npz")
    assert registry.resolve("en", "accurate").det_ckpt == str(tmp_path / "det_server.npz")
    assert W.load_rec_meta("en") is None


def test_opt_sidecar_paths(monkeypatch, tmp_path):
    monkeypatch.delenv("VSE_OPT_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    base = str(tmp_path / "models" / "rec_en_mobile")
    assert registry.opt_path(base) == str(
        tmp_path / "home" / ".cache" / "vse_tpu_torch" / "opt" / "rec_en_mobile.opt")
    assert registry.find_opt_sidecar(base) is None
    # a sibling <base>.opt is honoured, the cache dir's first
    W.save_flat({"a": np.zeros(2, np.float32)}, base + ".opt", {"step": 1})
    assert registry.find_opt_sidecar(base) == os.path.abspath(base) + ".opt"
    monkeypatch.setenv("VSE_OPT_DIR", str(tmp_path / "opt"))
    W.save_flat({"a": np.ones(2, np.float32)}, registry.opt_path(base), {"step": 2})
    assert registry.find_opt_sidecar(base) == str(tmp_path / "opt" / "rec_en_mobile.opt")
    assert W.load_meta(registry.find_opt_sidecar(base)) == {"step": 2}


def test_save_flat_writes_npz_and_meta_and_leaves_no_temporary(tmp_path):
    base = str(tmp_path / "sub" / "det_mobile")
    flat = W.to_jax_det(flax_init(DBDetector("mobile", train_outputs=True), 0).state_dict())
    W.save_flat(flat, base, {"variant": "mobile", "step": 7})
    assert sorted(os.listdir(tmp_path / "sub")) == ["det_mobile.npz", "det_mobile.vse_meta.json"]
    assert same(W.load_flat(base + ".npz"), flat)
    with open(base + ".vse_meta.json", encoding="utf-8") as f:
        assert json.load(f) == {"variant": "mobile", "step": 7}
    # the engine's loader reads a trained det's inference head only
    sd = W.load_det_server(base + ".npz")
    assert not any(k.startswith("head_thresh.") for k in sd)
    DBDetector("mobile").load_state_dict(sd)
    DBDetector("mobile", train_outputs=True).load_state_dict(W.from_jax_det(W.load_flat(base + ".npz")))
    assert W.load_meta(str(tmp_path / "missing")) is None
