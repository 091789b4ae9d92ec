"""The port's CRNN in training mode (f32, batch statistics) against the
flax module with ``train=True, mutable=["batch_stats"]``, from the JAX init
(seed 0) carried across with ``weights.from_jax_params``; gradients
carried back with ``to_jax_params`` (the det: ``test_torch_train_det.py``).

Tolerances: logits within 1e-4; new running statistics within 1e-5
(relative, for the variances); each gradient tensor within 1e-4 of its own
largest value (3.3e-5 at worst here). A tensor whose JAX gradient is zero
to rounding, at most 1e-4 of the model's largest (these are at most 2e-6
of it here, the others at least 2.8e-4), is held within 1e-4 of the
model's largest instead: its gradient is 0 in exact arithmetic and the
f32 sums leave noise alone. Those are the 11 projection BatchNorms' biases
(``InvertedResidual_*/ConvBNAct_2``: the next BatchNorm subtracts any
constant) and the scales of the first three expansion BatchNorms (a ReLU of
a zero-bias BatchNorm is homogeneous in its scale, and the depthwise
BatchNorm after it normalizes the scale away but for its epsilon).
"""

import re


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from _torch_helpers import two_threads  # noqa: F401
from vse_tpu.models.crnn import CRNNRecognizer as JaxCRNN
from vse_tpu.train import losses as jl
from vse_tpu_torch import weights as W
from vse_tpu_torch.models.crnn import CRNNRecognizer
from vse_tpu_torch.train import losses as tl
from vse_tpu_torch.train.pretrain import trainable


def flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(jax.device_get(tree)).items()}


def grads_by_flax_key(model, grads, to_jax):
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    by_name = dict(zip(names, grads))
    sd = {k: by_name.get(k, torch.zeros_like(v)) for k, v in model.state_dict().items()}
    return {k: v for k, v in to_jax(sd).items() if k.startswith("params/")}


def assert_grads_close(got, want, rtol=1e-4):
    """Each tensor within ``rtol`` of its own largest JAX gradient, or of
    the model's largest where its own is zero to rounding (at most 1e-4 of
    that). Returns the keys held to the model's largest."""
    assert got.keys() == want.keys()
    gmax = max(np.abs(v).max() for v in want.values())
    exempt = []
    for k, w in want.items():
        scale = np.abs(w).max()
        if scale <= 1e-4 * gmax:
            exempt.append(k)
            scale = gmax
        err = np.abs(got[k] - w).max()
        assert err <= rtol * scale, (k, err, scale)
    return exempt


def assert_exempt(exempt, bias, scale):
    """The tensors held to the model's largest gradient are biases before a
    BatchNorm (``bias``) and the expansion BatchNorms' scales (``scale``)."""
    n_bias = sum(bool(re.search(bias, k)) for k in exempt)
    n_scale = sum(bool(re.search(scale, k)) for k in exempt)
    assert n_bias + n_scale == len(exempt), exempt
    return n_bias, n_scale


def assert_stats_close(got, want, rtol=1e-5):
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def rec_case():
    rng = np.random.default_rng(0)
    model = JaxCRNN(vocab_size=68, dtype=jnp.float32)
    x = rng.standard_normal((4, 48, 160, 3)).astype(np.float32)
    v = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jnp.zeros((1, 48, 160, 3)), train=True)
    labels = np.zeros((4, 10), np.int32)
    lengths = np.array([3, 10, 1, 6], np.int32)
    for b in range(4):
        labels[b, : lengths[b]] = rng.integers(1, 69, lengths[b])
    labels[1, :4] = [5, 5, 9, 9]

    def loss_fn(p):
        logits, mut = model.apply({"params": p, "batch_stats": v["batch_stats"]}, x,
                                  train=True, mutable=["batch_stats"])
        return jl.ctc_rec_loss(logits, labels, lengths), (logits, mut["batch_stats"])

    (loss, (logits, bs)), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
    return dict(init=flat(v), x=x, labels=labels, lengths=lengths, loss=float(loss),
                logits=np.asarray(logits), bs=flat({"batch_stats": bs}),
                grads=flat({"params": g}))


def test_crnn_train_forward_stats_and_gradients_match_flax(rec_case):
    c = rec_case
    m = CRNNRecognizer(68)
    m.load_state_dict(W.from_jax_params(c["init"]))
    m.train()
    logits = m(torch.tensor(c["x"]))
    loss = tl.ctc_rec_loss(logits, torch.tensor(c["labels"]), torch.tensor(c["lengths"]))
    grads = torch.autograd.grad(loss, trainable(m))
    np.testing.assert_allclose(logits.detach().numpy(), c["logits"], rtol=0, atol=1e-4)
    assert float(loss) == pytest.approx(c["loss"], rel=1e-5)
    stats = {k: v for k, v in W.to_jax_params(m.state_dict()).items()
             if k.startswith("batch_stats/")}
    assert_stats_close(stats, c["bs"])
    exempt = assert_grads_close(grads_by_flax_key(m, grads, W.to_jax_params), c["grads"])
    assert assert_exempt(exempt, r"InvertedResidual_\d+/ConvBNAct_2/BatchNorm_0/bias$",
                         r"InvertedResidual_[0-2]/ConvBNAct_0/BatchNorm_0/scale$") == (11, 3)


def test_crnn_lstm_input_biases_stay_zero_and_frozen(rec_case):
    """flax's cell has one bias a gate; the port trains ``bias_hh`` only."""
    m = CRNNRecognizer(68)
    frozen = [n for n, p in m.named_parameters() if not p.requires_grad]
    assert sorted(frozen) == sorted(f"{l}.bias_ih_l0{s}" for l in ("lstm1", "lstm2")
                                    for s in ("", "_reverse"))
    assert all(float(p.abs().max()) == 0.0 for n, p in m.named_parameters() if n in frozen)
    # the same trainable values as the flax module's params (its cells keep
    # 12 arrays where nn.LSTM keeps 3 a direction)
    assert sum(p.numel() for p in trainable(m)) == sum(v.size for v in rec_case["grads"].values())


def test_crnn_eval_mode_reads_the_running_statistics(rec_case):
    """After a training forward the running statistics moved by 0.1 towards
    the batch's, and eval mode normalizes with them as flax's
    ``use_running_average`` does."""
    c = rec_case
    m = CRNNRecognizer(68)
    m.load_state_dict(W.from_jax_params(c["init"]))
    m.train()
    with torch.no_grad():
        m(torch.tensor(c["x"]))
    m.eval()
    with torch.no_grad():
        got = m(torch.tensor(c["x"][:2])).numpy()
    want = jax.jit(JaxCRNN(vocab_size=68, dtype=jnp.float32).apply)(
        {"params": _unflat(c["init"])["params"], "batch_stats": _unflat(c["bs"])["batch_stats"]},
        jnp.asarray(c["x"][:2]))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def _unflat(fl):
    from flax.traverse_util import unflatten_dict

    return unflatten_dict({tuple(k.split("/")): v for k, v in fl.items()})
