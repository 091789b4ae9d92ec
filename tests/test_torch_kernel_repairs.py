"""The scan's gray and K1's logits dtypes, on the CPU, against the JAX package.

- The port's ``rgb_to_gray`` is the gray of the reference's JITTED scan
  (``_scan_stats_u8_jit``), where XLA computes
  ``fma(b', .114, fma(r', .299, g' * .587))`` with ``x' = u8 * f32(1/255)``:
  bit-exact on all 2^24 colours, and so is K2's table (``scan_lut``) fed
  through the same FMAs.
- The noisy band (``vse_tpu_torch.video.synth.noisy_band``), whose frame
  191 has a cell at the text-cell threshold, scans to the reference's
  ``text_cells`` exactly, and the committed JAX stats of it
  (``vse_tpu_torch/assets/smoke/noisy_band.npz``, which the card's smoke
  holds K2 against) equal a fresh JAX run.
- K1's plain version on f16 and bf16 logits decodes as the Pallas decode in
  interpret mode.

Tolerances: gray, text_cells, ids and masks exact; the other stats rtol
1e-5 / atol 1e-6 (sums in another order); scores atol 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vse_tpu.kernels import keyframe as jax_keyframe
from vse_tpu.kernels.ctc_decode import ctc_greedy_decode_pallas
from vse_tpu_torch.kernels import ctc_decode as k1
from vse_tpu_torch.kernels import keyframe as k2
from vse_tpu_torch.video.synth import SMOKE_FIXTURE, noisy_band


def all_colours(hi: int) -> np.ndarray:
    """The quarter ``hi`` of the 2^24 colours, as u8 [2^22, 3]."""
    idx = np.arange(hi << 22, (hi + 1) << 22, dtype=np.int64)
    return np.stack([idx >> 16, (idx >> 8) & 255, idx & 255], -1).astype(np.uint8)


def fma_gray_np(x: np.ndarray) -> np.ndarray:
    """The scan gray from x' values [.., 3] in numpy: each FMA in f64,
    rounded once to f32."""
    w = [float(np.float32(v)) for v in (0.299, 0.587, 0.114)]
    s = x[..., 1] * np.float32(w[1])
    s = (x[..., 0].astype(np.float64) * w[0] + s).astype(np.float32)
    return (x[..., 2].astype(np.float64) * w[2] + s).astype(np.float32)


@pytest.fixture(scope="module")
def jit_gray():
    return jax.jit(jax_keyframe.rgb_to_gray)


@pytest.mark.parametrize("hi", range(4))
def test_gray_is_the_jitted_gray_on_every_colour(jit_gray, hi):
    rgb = all_colours(hi)
    want = np.asarray(jit_gray(jnp.asarray(rgb)))
    got = k2.rgb_to_gray(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    lut = k2.scan_lut().numpy()
    via_lut = fma_gray_np(lut[rgb.astype(np.int64)])
    np.testing.assert_array_equal(via_lut.view(np.uint32), want.view(np.uint32))


def test_scan_lut_is_u8_times_f32_reciprocal():
    lut = k2.scan_lut().numpy()
    assert lut.shape == (256,) and lut.dtype == np.float32
    want = np.arange(256, dtype=np.float32) * np.float32(1.0 / 255.0)
    np.testing.assert_array_equal(lut.view(np.uint32), want.view(np.uint32))


def test_the_two_grays_differ_where_the_scan_says():
    """The eager (source-order) gray stays under its own name and is not the
    scan's: the two differ by an ulp or two on a large share of colours."""
    rgb = all_colours(1)[::64]
    eager = k2.rgb_to_gray_eager(torch.from_numpy(rgb)).numpy()
    fma = k2.rgb_to_gray(torch.from_numpy(rgb)).numpy()
    diff = np.abs(eager.view(np.int32).astype(np.int64) - fma.view(np.int32))
    assert diff.max() <= 2 and 0.2 < np.mean(diff > 0) < 0.6


@pytest.mark.parametrize("hi", range(4))
def test_eager_gray_is_the_eager_jax_gray_on_every_colour(hi):
    """The sync path's source-order gray (``rgb_to_gray_eager``) against the
    JAX package's ``rgb_to_gray`` run eagerly (op by op, no ``jax.jit``, as
    ``vse_tpu/sync/demux.py::make_keyframes`` runs it): bit-equal on all
    2^24 colours."""
    rgb = all_colours(hi)
    want = np.asarray(jax_keyframe.rgb_to_gray(jnp.asarray(rgb)))
    got = k2.rgb_to_gray_eager(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.fixture(scope="module")
def band():
    return noisy_band()


def scan_in_batches(scan, band):
    return np.concatenate([np.asarray(scan(band[i : i + 32])) for i in range(0, len(band), 32)])


def test_noisy_band_text_cells_exact(band):
    want = scan_in_batches(jax_keyframe.scan_stats_u8, band)
    got = scan_in_batches(lambda b: k2.scan_stats_u8(torch.from_numpy(b)).numpy(), band)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert want[190, 1] == np.float32(1) / np.float32(640)  # frame 191's one cell
    plain = scan_in_batches(
        lambda b: k2.frame_stats_plain(torch.from_numpy(b)).numpy(), band)
    np.testing.assert_array_equal(plain, got)  # the CPU wrapper is the plain version


def test_noisy_band_spans_match(band):
    want = scan_in_batches(jax_keyframe.scan_stats_u8, band)
    got = scan_in_batches(lambda b: k2.scan_stats_u8(torch.from_numpy(b)).numpy(), band)
    nos = np.arange(1, len(band) + 1)
    assert ([(s.start_frame, s.end_frame) for s in k2.find_spans(got, nos)]
            == [(s.start_frame, s.end_frame) for s in jax_keyframe.find_spans(want, nos)])


def test_committed_noisy_band_stats_equal_a_fresh_jax_run(band):
    with np.load(os.path.join(SMOKE_FIXTURE, "noisy_band.npz")) as z:
        committed = z["stats"]
    fresh = scan_in_batches(jax_keyframe.scan_stats_u8, band)
    assert committed.shape == (600, 4) and committed.dtype == np.float32
    np.testing.assert_array_equal(committed, fresh)


def k1_logits(n, t, c, seed):
    """Logits with exact ties at the max (after rounding to 16 bits too: the
    tie is a copy) and all-blank rows."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, t, c)) * 4.0).astype(np.float32)
    best = x[0].argmax(-1)
    x[0, np.arange(t), (best + 5) % c] = x[0].max(-1)
    x[1:3, :, 0] = x[1:3].max(-1) + 5.0
    return x


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
@pytest.mark.parametrize("n,t,c", [(8, 80, 69), (3, 20, 1000), (2, 6, 21249)])
def test_k1_plain_on_half_logits_matches_pallas(dtype, n, t, c):
    x32 = k1_logits(n, t, c, seed=c + t)
    xt = torch.from_numpy(x32).to(getattr(torch, dtype))
    xj = jnp.asarray(x32).astype(getattr(jnp, dtype))
    ids, mask, scores = k1.ctc_greedy_decode(xt)
    r_ids, r_mask, r_scores = ctc_greedy_decode_pallas(xj, interpret=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(r_mask))
    np.testing.assert_allclose(scores.numpy(), np.asarray(r_scores), rtol=1e-5, atol=1e-6)
    assert scores.dtype == torch.float32 and torch.all(scores[1:3] == 1.0)
    # the 16-bit logits decode as their f32 values do
    ids32, mask32, scores32 = k1.ctc_greedy_decode(xt.float())
    assert torch.equal(ids, ids32) and torch.equal(mask, mask32)
    assert torch.equal(scores, scores32)


def test_k2_geometry_refuses_a_grid_too_tall():
    """The grid's y dimension (frame runs) stops at 65535: more frames than
    65535 runs hold raise before any launch."""
    g = k2.launch_geometry(65535 * 8, 1, 1)
    assert g.run == 8 and g.n_runs == 65535
    with pytest.raises(ValueError, match="at most"):
        k2.launch_geometry(65535 * 8 + 1, 1, 1)


@pytest.mark.parametrize("n,t,c", [(8, 80, 69), (64, 80, 293), (2, 6, 21249)])
def test_k1_plain_decode_bits_do_not_depend_on_threads_or_offset(n, t, c):
    """ROADMAP fault 14: the plain decode's sums over C and over T have one
    order, so the same f32 logits decode to the same bits at 1, 2 and 6
    intra-op threads, and from a copy that starts at another storage
    offset (the f16 logits' f32 values, as in the check above)."""
    x = torch.from_numpy(k1_logits(n, t, c, seed=c + t)).half().float()
    threads = torch.get_num_threads()
    outs = []
    try:
        for k in (1, 2, 6):
            torch.set_num_threads(k)
            outs.append(k1.ctc_greedy_decode(x))
            for off in (1, 3, 17):
                buf = torch.empty(x.numel() + off)
                buf[off:] = x.reshape(-1)
                outs.append(k1.ctc_greedy_decode(buf[off:].view(x.shape)))
    finally:
        torch.set_num_threads(threads)
    for ids, mask, scores in outs[1:]:
        assert torch.equal(ids, outs[0][0]) and torch.equal(mask, outs[0][1])
        assert torch.equal(scores, outs[0][2])
    _, probs = k1.argmax_lse_plain(x)
    assert torch.equal(k1.tree_sum(probs), k1.tree_sum(probs.clone()))
