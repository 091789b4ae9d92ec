"""The port's DB detector in training mode (``train_outputs=True``: prob,
thresh and binary maps) against the flax module with ``train=True,
mutable=["batch_stats"]``, from the JAX init (seed 0) carried across with
``weights.from_jax_det``; gradients carried back with ``to_jax_det``.

Tolerances: the three maps within 1e-4; new running statistics within 5e-5
relative (flax's fast variance, mean(x^2) - mean^2, subtracts two f32 means
whose sums the port orders otherwise, 15 layers deep: 2.2e-5 at worst
here); each gradient tensor within 3e-4 of its own largest value (the
same statistics feed the BatchNorm backward: 1.8e-4 at worst here), and the
16 tensors whose JAX gradient is zero to rounding within 3e-4 of the
model's largest (``test_torch_train_models.py``): 8 projection
BatchNorms' biases and the two transposed convolutions' biases, each before
a BatchNorm, and the first six expansion BatchNorms' scales. Also the
CRNN's server variant (``pretrain rec --variant server``) against flax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import two_threads  # noqa: F401
from test_torch_train_models import (
    assert_exempt, assert_grads_close, assert_stats_close, flat, grads_by_flax_key,
)
from vse_tpu.models.crnn import CRNNRecognizer as JaxCRNN
from vse_tpu.models.db_detector import DBDetector as JaxDB
from vse_tpu.train import losses as jl
from vse_tpu_torch import weights as W
from vse_tpu_torch.models.crnn import CRNNRecognizer
from vse_tpu_torch.models.db_detector import DBDetector
from vse_tpu_torch.train import losses as tl
from vse_tpu_torch.train.pretrain import trainable


def test_det_train_outputs_stats_and_gradients_match_flax():
    rng = np.random.default_rng(2)
    model = JaxDB(variant="mobile", train_outputs=True, dtype=jnp.float32)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    v = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=True)
    gts = [(rng.uniform(size=(2, 64, 64)) < 0.2).astype(np.float32), np.ones((2, 64, 64), np.float32),
           rng.uniform(0.3, 0.7, (2, 64, 64)).astype(np.float32),
           (rng.uniform(size=(2, 64, 64)) < 0.4).astype(np.float32)]
    bs = {k: t for k, t in v.items() if k != "params"}

    def loss_fn(p):
        maps, mut = model.apply({"params": p, **bs}, x, train=True, mutable=["batch_stats"])
        return jl.db_loss(*maps, *gts)[0], (maps, mut)

    (loss, (maps, mut)), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    m = DBDetector("mobile", train_outputs=True)
    m.load_state_dict(W.from_jax_det(flat(v)))
    m.train()
    got = m(torch.tensor(x))
    tloss, _ = tl.db_loss(*got, *(torch.tensor(a) for a in gts))
    for a, b in zip(got, maps):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=0, atol=1e-4)
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)
    stats = {k: v for k, v in W.to_jax_det(m.state_dict()).items()
             if k.startswith("batch_stats/")}
    assert_stats_close(stats, flat({"batch_stats": mut["batch_stats"]}), rtol=5e-5)
    grads = torch.autograd.grad(tloss, trainable(m))
    exempt = assert_grads_close(grads_by_flax_key(m, grads, W.to_jax_det),
                                flat({"params": g}), rtol=3e-4)
    assert assert_exempt(
        exempt, r"(InvertedResidual_\d+/ConvBNAct_2/BatchNorm_0|ConvTranspose_0)/bias$",
        r"InvertedResidual_[0-5]/ConvBNAct_0/BatchNorm_0/scale$") == (10, 6)


def test_crnn_server_variant_matches_flax():
    """``--variant server``: MobileNetV3-large x1.0, hidden 256, in eval
    mode on its flax init."""
    model = JaxCRNN(vocab_size=68, variant="server", dtype=jnp.float32)
    x = np.random.default_rng(1).standard_normal((1, 48, 64, 3)).astype(np.float32)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 48, 64, 3)))
    want = jax.jit(model.apply)(v, x)
    m = CRNNRecognizer(68, variant="server")
    m.load_state_dict(W.from_jax_params(flat(v)))
    m.eval()
    with torch.no_grad():
        got = m(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    assert m.lstm1.hidden_size == 256
