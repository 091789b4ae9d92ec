"""``python -m vse_tpu_torch.train.pretrain`` on the CPU: the render
subcommand's datasets, ``rec`` and ``det`` through ``main`` into a
temporary ``$VSE_MODELS``, the engine serving the head it wrote, resume
(bit-exact against one uninterrupted run), the host-fed path, and the
refusal to run on a missing card.

The schedule needs more than 100 steps (optax's warmup-cosine refuses
``decay_steps <= warmup``, ``tests/test_torch_train_optim.py``), so the
runs take 101-104 steps, on datasets of narrow crops (48 x 64, short
words: 16 CTC steps) or small frames (64 x 128) placed under the loaders'
cache names, which keeps each run to a few seconds.
"""

import os

import numpy as np
import pytest
import torch

from _torch_helpers import two_threads  # noqa: F401
from vse_tpu_torch import weights as W
from vse_tpu_torch.models.crnn import CRNNRecognizer
from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
from vse_tpu_torch.train import optim, pretrain
from vse_tpu_torch.train.synth import SynthConfig, TextRenderer
from vse_tpu_torch.video.synth import load_fixture


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    for k in ("VSE_MODELS", "VSE_OPT_DIR", "VSE_DATA_DIR"):
        d = tmp_path / k.lower()
        d.mkdir()
        monkeypatch.setenv(k, str(d))
    return tmp_path


def narrow_rec_dataset(n=8, seed=0):
    """Crops of 48 x 64 with short words, as the rec loader stores them."""
    cs = pretrain._rec_train_charset("en", False, True)
    r = TextRenderer(cs, SynthConfig(rec_w=64, min_font=16, max_font=18, words_only=True,
                                     fixed_stroke=2), seed=seed)
    imgs, texts = zip(*(r.render_line() for _ in range(n)))
    for t in texts:
        ids = cs.encode(t)
        assert 0 < len(ids) + sum(a == b for a, b in zip(ids, ids[1:])) <= 16
    return np.stack(imgs), list(texts)


def place_rec(pregen, batch, n=8, seed=0):
    imgs, texts = narrow_rec_dataset(n, seed)
    np.savez_compressed(pretrain.rec_dataset_path("en", pregen, batch), images=imgs,
                        texts=np.array(texts))


def test_render_writes_the_loaders_datasets(dirs):
    pretrain.main(["render", "--language", "en", "--pregen", "1", "--batch", "3"])
    with np.load(pretrain.rec_dataset_path("en", 1, 3), allow_pickle=True) as z:
        imgs, texts = z["images"], list(z["texts"])
    want_imgs, want_texts = pretrain.render_rec_dataset("en", 3)
    assert texts == want_texts and np.array_equal(imgs, want_imgs)
    assert os.path.basename(pretrain.rec_dataset_path("en", 1, 3)) == \
        "vse_rec_ds_en_1x3_w1s2g6.npz"
    pretrain.main(["render", "--det", "--pregen", "2"])
    ds = pretrain.load_or_render_det_dataset(2)
    want = pretrain.render_det_dataset(2)
    assert ds.keys() == want.keys() and all(np.array_equal(ds[k], want[k]) for k in ds)
    assert ds["images"].shape == (2, 256, 448, 3) and ds["gt_thresh"].dtype == np.float16


def test_rec_without_a_card_refuses_unless_asked_for_the_cpu(dirs):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain.main(["rec", "--steps", "101", "--batch", "4", "--pregen", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain.main(["det", "--steps", "101", "--batch", "2", "--pregen", "4"])
    assert not os.listdir(os.environ["VSE_MODELS"])


def test_rec_cli_writes_a_head_the_engine_serves(dirs, capsys):
    place_rec(4, 2)
    pretrain.main(["rec", "--device", "cpu", "--steps", "101", "--batch", "2",
                   "--pregen", "4"])
    out = capsys.readouterr().out
    assert "[rec en] step 101 loss" in out and "probe-exact" in out
    meta = W.load_rec_meta("en")
    assert meta == {"language": "en", "use_space_char": False, "fold_case": True,
                    "vocab_size": 68, "variant": "mobile", "hidden": 0, "cnn_scale": 0.0,
                    "jamo": False, "homoglyph_fold": False, "geometry": "tight1", "step": 101}
    assert os.path.exists(os.path.join(os.environ["VSE_OPT_DIR"], "rec_en_mobile.opt.npz"))
    engine = OcrEngine(language="en", device="cpu")
    assert engine.charset.vocab_size == 68
    bands, _ = load_fixture()
    res = engine.predict_batch(bands["band0"][None])
    assert len(res) == 1 and all(isinstance(t, str) for t, _ in res[0][1])
    # a finished head is left alone by a run that asks for no more steps
    pretrain.main(["rec", "--device", "cpu", "--steps", "101", "--batch", "2",
                   "--pregen", "4"])
    assert "already at step 101 >= 101; nothing to do" in capsys.readouterr().out
    assert W.load_rec_meta("en")["step"] == 101


def _run(base_env, models, opt, **kw):
    os.environ["VSE_MODELS"], os.environ["VSE_OPT_DIR"] = models, opt
    os.makedirs(models, exist_ok=True)
    return pretrain.train_rec("en", lr=1e-3, seed=0, pregen=4, batch=2, device="cpu",
                              **{"steps": 104, **kw})


class Stop(Exception):
    pass


def test_fresh_and_fresh_opt_choose_what_to_resume(dirs, monkeypatch, capsys):
    """A plain rerun resumes the head and its optimizer sidecar;
    ``--fresh-opt`` keeps the weights at their step and schedules over the
    remaining steps (a warmup of 200, so more than 200 must remain, as in
    the JAX package); ``--fresh`` resumes nothing. Each run is stopped where
    the device loop would start."""
    from vse_tpu_torch.train import device_loop

    def stop(**kw):
        raise Stop(kw["start_step"])

    monkeypatch.setattr(device_loop, "run_rec_device_loop", stop)
    place_rec(4, 2)
    m, o = os.environ["VSE_MODELS"], os.environ["VSE_OPT_DIR"]
    # a head and its sidecar at step 101, as a finished 101-step run leaves them
    model = pretrain.flax_init(CRNNRecognizer(68), 0)
    base = os.path.join(m, "rec_en_mobile")
    opt = optim.Optimizer(pretrain.rec_optimizer(1e-3, 100, 101), pretrain.trainable(model))
    pretrain.save_optimizer(opt, base, 101)
    W.save_flat(W.to_jax_params(model.state_dict()), base,
                {"vocab_size": 68, "hidden": 0, "cnn_scale": 0.0, "step": 101})
    for kw, start, want in (
            ({}, 101, ["from step 101", "restored optimizer state (adam moments + schedule)"]),
            ({"fresh_opt": True}, 101, ["from step 101 (fresh optimizer)"]),
            ({"fresh": True}, 0, [])):
        capsys.readouterr()
        with pytest.raises(Stop) as stopped:
            _run(dirs, m, o, steps=303, **kw)
        lines = [x for x in capsys.readouterr().out.splitlines()
                 if not x.startswith("loading cached dataset")]
        assert stopped.value.args == (start,)
        for line, w in zip(lines, want):
            assert w in line, (kw, lines)
        assert len(lines) == len(want), (kw, lines)
    with pytest.raises(ValueError, match="positive decay_steps"):
        _run(dirs, m, o, steps=205, fresh_opt=True)


def test_host_fed_path_trains(dirs, capsys):
    """``--host-data``: batches from a host thread with the numpy / OpenCV
    augmentation."""
    place_rec(4, 2)
    base = _run(dirs, os.environ["VSE_MODELS"], os.environ["VSE_OPT_DIR"], steps=101,
                device_data=False)
    steps = [x for x in capsys.readouterr().out.splitlines() if x.startswith("[rec en] step ")]
    assert steps[0].startswith("[rec en] step 0 loss") and "sample-exact" in steps[0]
    assert steps[-1].startswith("[rec en] step 100 loss")
    assert W.load_meta(base)["step"] == 101
