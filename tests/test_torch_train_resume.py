"""``pretrain`` on the CPU, continued (``test_torch_train_pretrain.py``):
resume after a kill, bit-exact against one uninterrupted run, and ``det``
through ``main`` on small frames (64 x 128) placed under the det loader's
cache name."""

import os

import numpy as np
import pytest

from _torch_helpers import two_threads  # noqa: F401
from test_torch_train_pretrain import _run, dirs, place_rec  # noqa: F401
from vse_tpu_torch import weights as W
from vse_tpu_torch.core.charset import get_charset
from vse_tpu_torch.models.db_detector import DBDetector
from vse_tpu_torch.train import pretrain
from vse_tpu_torch.train.synth import SynthConfig, TextRenderer


def test_resume_after_a_kill_equals_one_run(dirs, monkeypatch, capsys):
    """Killed right after its step-2 checkpoint (head and optimizer
    sidecar; the device loop made to checkpoint every 2 steps), then rerun
    with the same arguments: it resumes at step 2 and ends bit-equal to an
    uninterrupted 104-step run (weights, running statistics, Adam moments
    and counts)."""
    from vse_tpu_torch.train import device_loop

    place_rec(4, 2)

    class Killed(Exception):
        pass

    real = device_loop.run_rec_device_loop

    def killed_at_2(checkpoint_cb, **kw):
        def cb(step):
            checkpoint_cb(step)
            if step == 2:
                raise Killed()

        return real(checkpoint_cb=cb, checkpoint_every=2, **kw)

    a, b = (str(dirs / d) for d in ("a", "b"))
    _run(dirs, a + "/m", a + "/o")
    with monkeypatch.context() as m:
        m.setattr(device_loop, "run_rec_device_loop", killed_at_2)
        with pytest.raises(Killed):
            _run(dirs, b + "/m", b + "/o")
    assert W.load_meta(b + "/m/rec_en_mobile")["step"] == 2
    capsys.readouterr()
    _run(dirs, b + "/m", b + "/o")
    lines = capsys.readouterr().out.splitlines()
    assert "resuming" in lines[0] and "from step 2" in lines[0], lines
    assert lines[1] == "restored optimizer state (adam moments + schedule)"
    for name in ("m/rec_en_mobile.npz", "o/rec_en_mobile.opt.npz"):
        fa, fb = W.load_flat(f"{a}/{name}"), W.load_flat(f"{b}/{name}")
        assert fa.keys() == fb.keys()
        assert all(np.array_equal(fa[k], fb[k]) for k in fa), name


def test_det_cli_trains_both_heads(dirs, capsys):
    r = TextRenderer(get_charset("en"), SynthConfig(det_h=64, det_w=128, min_font=12,
                                                    max_font=14), seed=0)
    frames, maps = [], {k: [] for k in ("gt_shrink", "gt_shrink_mask", "gt_thresh",
                                        "gt_thresh_mask")}
    for _ in range(4):
        img, boxes = r.render_frame()
        frames.append(img)
        for k, v in r.det_labels(boxes).items():
            maps[k].append(v)
    np.savez_compressed(pretrain.det_dataset_path(4), images=np.stack(frames),
                        **{k: np.stack(v).astype(np.float16) for k, v in maps.items()})
    pretrain.main(["det", "--device", "cpu", "--steps", "101", "--batch", "1",
                   "--pregen", "4"])
    out = capsys.readouterr().out
    assert "[det] step 101 loss" in out and "bce" in out and "dice" in out
    base = os.path.join(os.environ["VSE_MODELS"], "det_mobile")
    assert W.load_meta(base) == {"variant": "mobile", "step": 101}
    flat = W.load_flat(base + ".npz")
    assert any(k.startswith("params/head_thresh/") for k in flat)
    DBDetector("mobile", train_outputs=True).load_state_dict(W.from_jax_det(flat))
    DBDetector("mobile").load_state_dict(W.load_det_server(base + ".npz"))
