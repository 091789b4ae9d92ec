"""Parity of the ops that modes accurate and auto add to the port with the
JAX package's, on the same seeded numpy inputs: the unpooled DB
postprocess (``db_pool`` 1), the det-only letterbox of ``detect_batch``,
the rectified crops and the host prefix beam.

Tolerances: boxes and valid masks of the postprocess exactly, its scores
and angles within 1e-5 (f32 sums in another order); the letterbox within
1e-4 gray levels of ``jax.image.resize`` and its normalization exactly;
quads within 1e-4 px; rectified crops within 0.05 gray levels (the 8x8
homography solve differs in its last bits, which moves a sample point by
~1e-4 px); the beam's ids exactly and its score within 1e-6 (both copy
the same numpy code).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from vse_tpu.ops import ctc as jax_ctc
from vse_tpu.ops import db_postprocess as jax_db
from vse_tpu.ops import image as jax_image
from vse_tpu_torch.ops import ctc
from vse_tpu_torch.ops import db_postprocess as db
from vse_tpu_torch.ops import image


def prob_map(rng, B=3, H=64, W=96):
    """Low background with up to 11 rectangles of high probability, some
    touching (one component) and some under ``min_area``."""
    p = rng.uniform(0, 0.25, (B, H, W)).astype(np.float32)
    for b in range(B):
        for _ in range(rng.integers(1, 12)):
            y, x = rng.integers(0, H - 8), rng.integers(0, W - 20)
            p[b, y : y + rng.integers(2, 8), x : x + rng.integers(3, 20)] = rng.uniform(0.5, 1.0)
    return p


@pytest.mark.parametrize("seed,sweeps", [(0, 1), (1, 4)])
def test_unpooled_postprocess_matches_jax(seed, sweeps):
    p = prob_map(np.random.default_rng(seed))
    want = [np.asarray(a) for a in jax_db.db_postprocess(
        jnp.asarray(p), max_boxes=8, pool=1, num_sweeps=sweeps, with_angles=True)]
    got = [a.numpy() for a in db.db_postprocess(
        torch.from_numpy(p), max_boxes=8, pool=1, num_sweeps=sweeps)]
    np.testing.assert_array_equal(got[0], want[0])  # boxes
    np.testing.assert_array_equal(got[2], want[2])  # valid
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5)
    assert want[2].any()


def test_component_boxes_and_host_reference_match_jax():
    p = prob_map(np.random.default_rng(7), B=1)[0]
    hit = p > 0.3
    want = jax.jit(jax_db.component_boxes, static_argnums=(1, 2))(
        jnp.asarray(hit), 8, 4, jnp.asarray(np.where(hit, p, 0)),
        jnp.asarray(hit.astype(np.float32)))
    got = db.component_boxes(torch.from_numpy(hit)[None], 8, 4,
                             torch.from_numpy(np.where(hit, p, 0))[None],
                             torch.from_numpy(hit.astype(np.float32))[None])
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2][0].numpy(), np.asarray(want[2]), atol=1e-5)
    for a, b in zip(db.db_postprocess_host(p), jax_db.db_postprocess_host(p)):
        np.testing.assert_array_equal(a, b)
    boxes = np.asarray(want[0])
    np.testing.assert_allclose(
        db.box_mean_scores(torch.from_numpy(p), torch.from_numpy(boxes.copy())).numpy(),
        np.asarray(jax_db.box_mean_scores(jnp.asarray(p), jnp.asarray(boxes))), atol=1e-5)


@pytest.mark.parametrize("h,w,hd,wd", [(152, 1280, 160, 960), (45, 70, 64, 96)])
def test_det_only_letterbox_matches_jax_resize(h, w, hd, wd):
    f = np.random.default_rng(h).integers(0, 256, (2, h, w, 3), np.uint8)
    scale = min(hd / h, wd / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    want = np.asarray(jax.jit(lambda x: jax.image.resize(
        x.astype(jnp.float32), (2, nh, nw, 3), method="bilinear"))(f))
    canvas, inv = image.letterbox_resize(torch.from_numpy(f), hd, wd)
    assert inv == 1.0 / scale and canvas.shape == (2, hd, wd, 3)
    np.testing.assert_allclose(canvas[:, :nh, :nw].numpy(), want, rtol=0, atol=1e-4)
    assert not canvas[:, nh:].any() and not canvas[:, :, nw:].any()
    c = canvas.numpy()
    np.testing.assert_array_equal(image.normalize_det(canvas).numpy(),
                                  np.asarray(jax.jit(jax_image.normalize_det)(c)))


def test_rectified_crops_match_jax():
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, 152, 640, 3)).astype(np.float32)
    boxes = np.array([[[10, 20, 300, 60], [400, 30, 600, 70], [0, 0, 0, 0]],
                      [[5, 100, 200, 140], [50, 50, 630, 90], [300, 10, 400, 40]]], np.float32)
    angles = rng.uniform(-0.4, 0.4, (2, 3)).astype(np.float32)
    angles[1, 2] = 0.78  # near 45 degrees: the bbox fallback
    want_q = np.asarray(jax.jit(jax_image.quads_from_boxes)(boxes, angles))
    got_q = image.quads_from_boxes(torch.from_numpy(boxes), torch.from_numpy(angles)).numpy()
    np.testing.assert_allclose(got_q, want_q, rtol=0, atol=1e-4)
    crop = jax.vmap(lambda f, qs: jax.vmap(
        lambda q: jax_image.crop_quad_rectified_windowed(f, q, 48, 320, 96))(qs))
    want = np.asarray(jax.jit(crop)(frames, want_q))
    got = image.crop_quads_rectified_windowed(
        torch.from_numpy(frames), torch.from_numpy(want_q), 48, 320, 96).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
    assert np.abs(want).sum() > 0
    want = np.asarray(jax.jit(lambda f, q: jax_image.crop_and_rectify(f, q, 48, 320))(
        frames[1], want_q[1]))
    got = image.crop_and_rectify(torch.from_numpy(frames[1]), torch.from_numpy(want_q[1]),
                                 48, 320).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)


@settings(max_examples=60, deadline=None)
@given(t=st.integers(1, 30), c=st.integers(2, 12), beam=st.integers(1, 8),
       seed=st.integers(0, 2 ** 16), peaked=st.booleans())
def test_prefix_beam_matches_jax(t, c, beam, seed, peaked):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, c)).astype(np.float32) * (6.0 if peaked else 1.0)
    logp = x - np.log(np.exp(x).sum(-1, keepdims=True))
    top_k = min(16, c)
    ids, score = ctc.ctc_prefix_beam_decode(logp, beam_width=beam, top_k=top_k)
    want_ids, want_score = jax_ctc.ctc_prefix_beam_decode(logp, beam_width=beam, top_k=top_k)
    assert [int(i) for i in ids] == [int(i) for i in want_ids]
    assert abs(score - want_score) <= 1e-6
