"""The training slice as a whole on the CPU at full width: ``train_rec``'s
step (``pretrain.rec_step``) and optimizer for ``steps=300, lr=1e-3``,
batch 64 at 48 x 320, from ``train_rec``'s own init, for 20 steps on the
fixed batches of ``assets/smoke/reference_train.json`` (the JAX package's
``step_core`` on the same batches, ``tools/make_torch_smoke_fixture.py
--train``). Each loss within 1% of the JAX step's (3.4e-6 at most on the
CPU where the fixture was made; 1.6e-5 on an H100), and the greedy reads of
the 4 probe crops after step 20 equal (empty on both sides). Then the same
step and optimizer for 5 steps from the committed en head, whose probe
reads are real text: equal to the JAX step's. The committed datasets are
what the port's renderer draws.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_helpers import two_threads  # noqa: F401
from vse_tpu_torch.models.crnn import CRNNRecognizer
from vse_tpu_torch.train import optim, pretrain
from vse_tpu_torch.train.synth import TextRenderer
from vse_tpu_torch.video.synth import SMOKE_FIXTURE
from vse_tpu_torch.weights import from_jax_params, load_flat, load_rec_flat


@pytest.fixture(scope="module")
def data():
    with open(os.path.join(SMOKE_FIXTURE, "reference_train.json"), encoding="utf-8") as f:
        ref = json.load(f)["rec"]
    with np.load(os.path.join(SMOKE_FIXTURE, "train_rec_en.npz")) as z:
        return ref, z["images"], [str(t) for t in z["texts"]]


def steps_from(flat, data, n):
    """``n`` of ``train_rec``'s steps from the flat variables ``flat`` on
    the fixture's batches; (model, optimizer, losses, probe reads)."""
    ref, images, texts = data
    charset = pretrain._rec_train_charset("en", False, True)
    labels, lengths = pretrain.encode_labels(
        charset, texts, pretrain.rec_train_config(charset).max_label_len)
    x = torch.from_numpy((images.astype(np.float32) / 255.0 - 0.5) / 0.5)
    model = CRNNRecognizer(charset.vocab_size)
    model.load_state_dict(from_jax_params(flat))
    opt = optim.Optimizer(pretrain.rec_optimizer(ref["lr"], 100, ref["steps"]),
                          pretrain.trainable(model))
    losses = [float(pretrain.rec_step(model, opt, x[idx], torch.from_numpy(labels[idx]),
                                      torch.from_numpy(lengths[idx])))
              for idx in ref["indices"][:n]]
    return model, opt, losses, pretrain.predict_texts(model, x[:4], charset)


def test_twenty_rec_steps_follow_the_jax_step(data):
    ref = data[0]
    _, opt, losses, probe = steps_from(
        load_flat(os.path.join(SMOKE_FIXTURE, "train_rec_init.npz")), data, 20)
    gaps = [abs(a - b) / b for a, b in zip(losses, ref["losses"])]
    print("largest gap", max(gaps), "by step", [f"{g:.1e}" for g in gaps])
    assert max(gaps) <= 0.01
    assert int(opt.state[1][0]["count"]) == len(ref["indices"]) == 20
    assert probe == ref["probe_texts"]


def test_steps_from_the_en_head_read_as_the_jax_steps_do(data):
    """From the trained head the losses are 7e-5 to 2.5e-3 a batch, near
    the f32 resolution of the CTC sums (0.6% apart at worst here), so only
    the reads are compared."""
    ref = data[0]
    _, _, losses, probe = steps_from(load_rec_flat("en"), data, len(ref["head_losses"]))
    print("losses", losses, "JAX", ref["head_losses"])
    assert all(t for t in ref["head_probe_texts"])
    assert probe == ref["head_probe_texts"]


def test_committed_datasets_are_the_renderers(data):
    """The first crops of ``train_rec_en.npz`` in curriculum order, and the
    first frame of ``train_det_en.npz`` with its maps, as the port draws
    them (the card's machine has no renderer and reads these files)."""
    _, images, texts = data
    assert images.shape == (256, 48, 320, 3) and len(texts) == 256
    r = TextRenderer(pretrain._rec_train_charset("en", False, True),
                     pretrain.rec_render_config(), seed=0)
    for bi in range(4):
        r.cfg.difficulty = min(1.0, 2.0 * bi / 256)
        img, text = r.render_line()
        assert text == texts[bi] and np.array_equal(img, images[bi])
    with np.load(os.path.join(SMOKE_FIXTURE, "train_det_en.npz")) as z:
        ds = {k: z[k] for k in z.files}
    assert ds["images"].shape == (16, 256, 448, 3)
    want = pretrain.render_det_dataset(1)
    assert all(np.array_equal(ds[k][:1], want[k]) for k in want)
