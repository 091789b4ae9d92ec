"""Parity of the PyTorch port's kernel modules with the JAX package.

K1 (greedy-CTC argmax / softmax prob) and K2 (keyframe stats): on the CPU
each wrapper runs its plain PyTorch version, held here against the JAX
oracle and the Pallas kernel in interpret mode on the same numpy inputs.
The CUDA kernels themselves are compared with the plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: ids, masks, text_cells and spans exact; scores and float stats
rtol 1e-5 / atol 1e-6 (f32 sums taken in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vse_tpu.kernels import ctc_decode as jax_ctc_kernel
from vse_tpu.kernels import keyframe as jax_keyframe
from vse_tpu.ops.ctc import ctc_greedy_decode as jax_ctc_greedy_decode
from vse_tpu_torch.kernels import _build
from vse_tpu_torch.kernels import ctc_decode as k1
from vse_tpu_torch.kernels import keyframe as k2


def ctc_logits(n, t, c, seed):
    """Random logits with exact ties (the max copied to a later class in
    row 0 and an earlier class in row 1) and all-blank rows 2-3."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, t, c)) * 4.0).astype(np.float32)
    for row, shift in ((0, 7), (1, c - 3)):
        best = x[row].argmax(-1)
        x[row, np.arange(t), (best + shift) % c] = x[row].max(-1)
    x[2:4, :, 0] = x[2:4].max(-1) + 5.0
    return x


@pytest.mark.parametrize("n,t,c", [(16, 80, 69), (4, 80, 21249)])
def test_k1_plain_matches_jax_oracle_and_pallas(n, t, c):
    x = ctc_logits(n, t, c, seed=c)
    ids, mask, scores = (a.numpy() for a in k1.ctc_greedy_decode(torch.from_numpy(x)))
    for ref in (jax_ctc_greedy_decode(jnp.asarray(x)),
                jax_ctc_kernel.ctc_greedy_decode_pallas(jnp.asarray(x), interpret=True)):
        r_ids, r_mask, r_scores = (np.asarray(a) for a in ref)
        np.testing.assert_array_equal(mask, r_mask)
        np.testing.assert_array_equal(ids, r_ids)
        np.testing.assert_allclose(scores, r_scores, rtol=1e-5, atol=1e-6)
    assert np.all(scores[2:4] == 1.0)  # all-blank rows
    assert ids.dtype == np.int32 and mask.dtype == bool and scores.dtype == np.float32


def test_k1_ties_keep_first_max():
    x = np.zeros((1, 3, 5), np.float32)
    x[0, 0, [1, 3]] = 2.0  # tie -> 1
    x[0, 1, [4, 2]] = 2.0  # tie -> 2
    x[0, 2, [0, 4]] = 2.0  # tie -> blank
    best, prob = k1.argmax_lse_plain(torch.from_numpy(x))
    assert best.tolist() == [[1, 2, 0]]
    ids, mask, _ = k1.ctc_greedy_decode(torch.from_numpy(x))
    assert ids[0][mask[0]].tolist() == [1, 2]
    np.testing.assert_allclose(prob.numpy(), np.exp(2.0) / (2 * np.exp(2.0) + 3), rtol=1e-6)


def band_u8(t, h, w, seed, text_rows=None):
    """uint8 frames: smooth noise plus, optionally, a striped 'text' block
    that appears from frame 3 (so diffs and text cells both vary)."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 40, (t, h, w, 3)).astype(np.uint8)
    if text_rows is not None:
        y0, y1 = text_rows
        f[3:, y0:y1, 4 : w - 4 : 3] = 250
    return f


@pytest.mark.parametrize("shape", [(32, 40, 256), (32, 37, 301), (7, 9, 130)])
def test_k2_plain_matches_pallas_and_jnp(shape):
    t, h, w = shape
    f = band_u8(t, h, w, seed=h * w, text_rows=(h // 4, h // 4 + 12))
    got = k2.scan_stats_u8(torch.from_numpy(f)).numpy()
    ref_jnp = jax_keyframe.scan_stats_u8(f, force_jnp=True)
    gray = np.asarray(jax_keyframe.rgb_to_gray(jnp.asarray(f)))
    padded = jax_keyframe._pad_hw(gray, jax_keyframe.ScanParams())
    ref_pallas = np.asarray(jax_keyframe.frame_stats_pallas(jnp.asarray(padded), interpret=True))
    assert k2.padded_hw(h, w) == padded.shape[1:]
    for ref in (ref_jnp, ref_pallas):
        np.testing.assert_array_equal(got[:, 1], ref[:, 1])  # text_cells
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert got[0, 2] == 0.0  # frame 0 is its own prev
    assert got[:, 1].max() > 0.0  # the striped block registers text cells


def test_k2_batch_boundary_diff_is_zero():
    """Scanning in batches of 32 zeroes the diff of every 32nd frame, as the
    reference does (prev is the previous frame of the BATCH)."""
    f = band_u8(64, 16, 128, seed=3)
    whole = k2.scan_stats_u8(torch.from_numpy(f)).numpy()
    batched = np.concatenate(
        [k2.scan_stats_u8(torch.from_numpy(f[i : i + 32])).numpy() for i in (0, 32)]
    )
    ref = np.concatenate(
        [jax_keyframe.scan_stats_u8(f[i : i + 32], force_jnp=True) for i in (0, 32)]
    )
    assert whole[32, 2] > 0.0 and batched[32, 2] == 0.0
    np.testing.assert_allclose(batched, ref, rtol=1e-5, atol=1e-6)


def test_find_spans_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(5):
        stats = rng.uniform(0, 0.06, (200, 4)).astype(np.float32)
        stats[rng.integers(0, 200, 20), 2] = 0.2
        nos = np.arange(1, 201, dtype=np.int64)
        got = [(s.start_frame, s.end_frame) for s in k2.find_spans(stats, nos)]
        ref = [(s.start_frame, s.end_frame) for s in jax_keyframe.find_spans(stats, nos)]
        assert got == ref


def test_wrappers_use_plain_version_only_on_cpu():
    before = (k1.launches, k2.launches)
    k1.ctc_greedy_decode(torch.zeros((2, 4, 5)))
    k2.scan_stats_u8(torch.zeros((2, 8, 8, 3), dtype=torch.uint8))
    assert (k1.launches, k2.launches) == before  # CPU calls launch nothing
    with pytest.raises(ValueError):
        k1.ctc_greedy_decode(torch.zeros((2, 4, 5), device="meta"))
    with pytest.raises(ValueError):
        k2.scan_stats_u8(torch.zeros((2, 8, 8, 3), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError):
        k1.greedy_decode_cuda(torch.zeros((2, 4, 5)))
    with pytest.raises(ValueError):
        k2.frame_stats_cuda(torch.zeros((2, 8, 8, 3), dtype=torch.uint8))


def test_build_without_nvcc_raises_clearly(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    srcs = _build._sources()
    assert [p.rsplit("/", 1)[1] for p in srcs] == ["ctc_decode.cu", "keyframe.cu"]
