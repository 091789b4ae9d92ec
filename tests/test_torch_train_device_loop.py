"""The device-resident training loops (``vse_tpu_torch/train/
device_loop.py``) against ``vse_tpu/train/device_loop.py``.

Tolerances: the resampling operators within 1e-6 of the JAX functions
(called as ``tests/test_device_loop.py`` calls them, op by op; XLA's
compiled program contracts some of their multiply-adds, 3.8e-6 away);
``ink_rows_batch`` exact; ``RecAugment.apply`` fed JAX's own draws (rebuilt
from the key splits of ``make_rec_augment``) within 0.02 of JAX's jitted
``augment`` on the 0-255 scale: the products sum in another order and the
sampling coordinates round otherwise where a glyph edge is steep (the JAX
package's own jit and op-by-op runs differ by 0.0054 on these crops).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import two_threads  # noqa: F401
from vse_tpu.train import device_loop as jdl
from vse_tpu_torch.train import device_loop as tdl
from vse_tpu_torch.video.synth import SMOKE_FIXTURE


@pytest.fixture(scope="module")
def crops():
    with np.load(os.path.join(SMOKE_FIXTURE, "train_rec_en.npz")) as z:
        return z["images"][[0, 70, 150, 250]].astype(np.float32)


@pytest.mark.parametrize("n,m_dst,m_src", [(48, 30, 48), (48, 48, 48), (320, 240, 320),
                                           (320, 237.3, 301.7), (17, 9, 17), (48, 48, 36)])
def test_bilinear_weights_match_jax(n, m_dst, m_src):
    want = np.asarray(jdl._bilinear_weights(n, n, m_dst, m_src))
    got = tdl._bilinear_weights(n, n, torch.tensor(float(m_dst)), float(m_src)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_batched_operators_match_jax():
    dd = np.array([200.0, 320.0, 24.0], np.float32)
    ss = np.array([280.0, 300.0, 24.0], np.float32)
    want = np.stack([np.asarray(jdl._bilinear_weights(320, 320, d, s)) for d, s in zip(dd, ss)])
    got = tdl._bilinear_weights(320, 320, torch.tensor(dd), torch.tensor(ss)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    a = np.array([3.3, -2.7, 10.25], np.float32)
    b = np.array([40.1, 55.9, 38.5], np.float32)
    want = np.stack([np.asarray(jdl.interval_resize_matrix(48, x, y)) for x, y in zip(a, b)])
    got = tdl.interval_resize_matrix(48, torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,m", [(48, 31), (48, 8), (320, 170), (320, 300)])
def test_resample_chain_matches_jax(n, m):
    want = np.asarray(jdl.resample_chain_matrix(n, m))
    got = tdl.resample_chain_matrix(n, torch.tensor(float(m))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("nh,y_off", [(20, 7), (30, 0), (41, 7)])
def test_crop_expand_matches_jax(nh, y_off):
    want = np.asarray(jdl.crop_expand_matrix(48, nh, y_off))
    got = tdl.crop_expand_matrix(48, nh, y_off).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_ink_rows_are_exact(crops):
    rng = np.random.default_rng(0)
    flat = np.full((1, 48, 320, 3), 90.0, np.float32)  # no ink: the whole height
    for x in (crops, rng.uniform(0, 255, (3, 48, 320, 3)).astype(np.float32), flat):
        jy0, jy1 = jdl.ink_rows_batch(jnp.asarray(x))
        ty0, ty1 = tdl.ink_rows_batch(torch.tensor(x))
        assert np.array_equal(ty0.numpy(), np.asarray(jy0))
        assert np.array_equal(ty1.numpy(), np.asarray(jy1))


def jax_draws(key, B, h, w):
    """``make_rec_augment``'s draws, from its own key splits."""
    ks = jax.random.split(key, 18)
    ks2 = jax.random.split(ks[11], 4)
    u = jax.random.uniform
    d = {"gain": u(ks[0], (B, 1, 1, 1), minval=0.7, maxval=1.3),
         "bias": u(ks[1], (B, 1, 1, 1), minval=-30.0, maxval=30.0),
         "chan": u(ks[2], (B, 1, 1, 3), minval=0.9, maxval=1.1),
         "sigma": u(ks[3], (), minval=0.0, maxval=8.0),
         "noise": jax.random.normal(ks[4], (B, h, w, 3)),
         "shift": jax.random.randint(ks[5], (), 0, 9),
         "sy": u(ks[6], (), minval=0.75, maxval=1.0),
         "mild": u(ks[7], (), minval=0.85, maxval=1.05),
         "resample_u": u(ks[8], ()), "in_band_u": u(ks[9], (B,)),
         "cjit": u(ks[10], (B,), minval=-0.08, maxval=0.08),
         "hard": u(ks[12], (), minval=0.55, maxval=0.85), "hard_u": u(ks[13], ()),
         "f_band": u(ks[14], (B,), minval=0.74, maxval=0.90),
         "f_tail": u(ks[15], (B,), minval=0.48, maxval=0.74),
         "aspect": u(ks2[0], (B,), minval=0.9, maxval=1.1), "fit_u": u(ks2[1], (B,)),
         "narrow_u": u(ks2[2], (B,)), "narrow": u(ks2[3], (B,), minval=0.6, maxval=1.0)}
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def test_augment_apply_matches_jax_on_jax_draws(crops):
    """[4, 48, 320, 3] crops of the committed training set, 12 keys: each
    branch (resample chain, hard squash, tail band, narrowing, no fit) is
    taken by some of them."""
    aug = jax.jit(jdl.make_rec_augment(48, 320))
    port = tdl.make_rec_augment(48, 320)
    taken = set()
    for s in range(12):
        key = jax.random.PRNGKey(s)
        want = np.asarray(aug(key, jnp.asarray(crops)))
        draws = jax_draws(key, 4, 48, 320)
        got = port.apply(draws, torch.tensor(crops)).numpy()
        assert np.abs(got - want).max() <= 0.02, s
        taken |= {"chain" if draws["resample_u"] < 0.5 else "no chain",
                  "hard" if draws["hard_u"] < 0.25 else "mild"}
        taken |= {"tail" for v in draws["in_band_u"] if v >= 0.8}
        taken |= {"no fit" for v in draws["fit_u"] if v >= 0.9}
    assert taken == {"chain", "no chain", "hard", "mild", "tail", "no fit"}


def test_draws_cover_every_key_of_the_jax_augment():
    d = tdl.make_rec_augment(48, 320).draw(torch.Generator().manual_seed(0), 4, "cpu")
    want = jax_draws(jax.random.PRNGKey(0), 4, 48, 320)
    assert d.keys() == want.keys()
    for k in d:
        assert d[k].shape == want[k].shape and d[k].dtype == want[k].dtype, k


def test_a_step_draws_the_same_whenever_it_runs():
    """The loops seed each step's generator from (seed, step): a resumed
    run draws what the uninterrupted run drew."""
    a = tdl._step_generator("cpu", 917, 41)
    torch.rand(5, generator=tdl._step_generator("cpu", 917, 40))
    b = tdl._step_generator("cpu", 917, 41)
    assert torch.equal(torch.rand(8, generator=a), torch.rand(8, generator=b))


def _linear_rec_step(target=0.3):
    w = torch.zeros((), requires_grad=True)

    def step(imgs, labels, lengths):
        loss = (w * imgs.mean() - target) ** 2
        (g,) = torch.autograd.grad(loss, [w])
        with torch.no_grad():
            w.sub_(0.05 * g)
        return loss.detach()

    return w, step


def test_rec_loop_optimizes_and_keeps_its_cadence():
    """As ``tests/test_device_loop.py``: a one-weight least-squares
    'recognizer' on bright images; logs every chunk, checkpoints every
    ``checkpoint_every`` and at the end."""
    rng = np.random.default_rng(0)
    raw = rng.integers(150, 255, size=(64, 8, 16, 3)).astype(np.uint8)
    labels = rng.integers(0, 5, size=(64, 4)).astype(np.int32)
    lengths = np.full((64,), 4, np.int32)
    w, step = _linear_rec_step()
    events = {"logs": [], "ckpts": []}
    hist = tdl.run_rec_device_loop(
        raw_imgs=raw, labels=labels, lengths=lengths, step_core=step, steps=40,
        start_step=0, batch=8, seed=0, device="cpu", chunk=10, checkpoint_every=20,
        checkpoint_cb=events["ckpts"].append,
        log_cb=lambda s, loss: events["logs"].append((s, loss)))
    assert events["ckpts"] == [20, 40]
    assert [s for s, _ in events["logs"]] == [10, 20, 30, 40]
    assert len(hist) == 40 and events["logs"][-1][1] == hist[-1]
    assert hist[-1] < hist[0] * 0.5 and np.isfinite(float(w))


def test_rec_loop_resumed_midway_equals_one_run():
    """Killed at its step-12 checkpoint and resumed from there, a run draws
    and computes what the uninterrupted run did, step for step."""
    rng = np.random.default_rng(1)
    raw = rng.integers(0, 255, size=(32, 8, 16, 3)).astype(np.uint8)
    kw = dict(raw_imgs=raw, labels=np.ones((32, 2), np.int32),
              lengths=np.full((32,), 2, np.int32), steps=30, batch=4, seed=3, device="cpu")
    w1, s1 = _linear_rec_step()
    whole = tdl.run_rec_device_loop(step_core=s1, start_step=0, chunk=7, **kw)

    class Killed(Exception):
        pass

    def kill(step):
        raise Killed(step)

    w2, s2 = _linear_rec_step()
    with pytest.raises(Killed):
        tdl.run_rec_device_loop(step_core=s2, start_step=0, chunk=5, checkpoint_every=12,
                                checkpoint_cb=kill, **kw)
    rest = tdl.run_rec_device_loop(step_core=s2, start_step=12, chunk=5, **kw)
    assert rest == whole[12:] and float(w2) == float(w1)


def test_det_loop_optimizes_and_keeps_its_cadence():
    rng = np.random.default_rng(0)
    ds = {"images": rng.integers(0, 255, size=(32, 16, 24, 3)).astype(np.uint8),
          "gt_shrink": rng.random((32, 16, 24)).astype(np.float16),
          "gt_shrink_mask": np.ones((32, 16, 24), np.float16),
          "gt_thresh": rng.random((32, 16, 24)).astype(np.float16),
          "gt_thresh_mask": np.ones((32, 16, 24), np.float16)}
    w = torch.zeros((), requires_grad=True)

    def step(batch):
        loss = (w * batch["det_images"].mean() - batch["gt_shrink"].mean()) ** 2
        (g,) = torch.autograd.grad(loss, [w])
        with torch.no_grad():
            w.sub_(0.1 * g)
        return loss.detach(), {"shrink_bce": loss.detach(), "binary_dice": loss.detach(),
                               "thresh_l1": loss.detach()}

    events = {"logs": [], "ckpts": []}
    tdl.run_det_device_loop(
        ds=ds, step_core=step, steps=30, start_step=0, batch=4, seed=0, device="cpu",
        chunk=10, checkpoint_every=20, checkpoint_cb=events["ckpts"].append,
        log_cb=lambda s, loss, m: events["logs"].append((s, loss, m)))
    assert events["ckpts"] == [20, 30]
    assert [s for s, _, _ in events["logs"]] == [10, 20, 30]
    assert events["logs"][-1][1] < events["logs"][0][1]
    assert set(events["logs"][0][2]) == {"shrink_bce", "binary_dice", "thresh_l1"}
