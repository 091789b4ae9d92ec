"""K2's gray tables and launch geometry, and K1's output layout, on the CPU.

The CUDA kernels cannot run here, so what surrounds them is checked in
Python: the gray lookup tables K2 reads (bit-equal to the plain version's
divide-and-multiply over every colour, and to the JAX package's eager
``rgb_to_gray``), K2's grid (every frame row, pixel and frame owned once),
a numpy walk of K2's strip algorithm over that grid against
``frame_stats_plain``, and K1's one-allocation output layout.

Tolerances: gray and text_cells exact; float stats rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vse_tpu.kernels import keyframe as jax_keyframe
from vse_tpu_torch.kernels import ctc_decode as k1
from vse_tpu_torch.kernels import keyframe as k2


def lut_gray(lut: np.ndarray, rgb: np.ndarray) -> np.ndarray:
    """K2's gray: (R[r] + G[g]) + B[b], each add rounded to f32."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return (lut[0][r] + lut[1][g]) + lut[2][b]


def test_gray_lut_is_rgb_to_gray_on_every_colour():
    lut = k2.gray_lut().numpy()
    assert lut.shape == (3, 256) and lut.dtype == np.float32
    for hi in range(4):  # 2^24 colours in four slices of 2^22
        idx = torch.arange(hi << 22, (hi + 1) << 22, dtype=torch.int64)
        rgb = torch.stack([idx >> 16, (idx >> 8) & 255, idx & 255], -1).to(torch.uint8)
        want = k2.rgb_to_gray(rgb).numpy()
        got = lut_gray(lut, rgb.numpy())
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_gray_lut_matches_jax_eager_gray():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (65536, 3)).astype(np.uint8)
    want = np.asarray(jax_keyframe.rgb_to_gray(jnp.asarray(rgb)))
    got = lut_gray(k2.gray_lut().numpy(), rgb)
    assert np.count_nonzero(got.view(np.uint32) != want.view(np.uint32)) == 0


GEOMETRY_CASES = [
    (32, 104, 1280, {}),  # the main path's band
    (32, 37, 301, {}),  # ragged: H % 4 != 0, W % 16 != 0
    (1, 8, 128, {}),
    (13, 9, 130, {"run": 4}),  # T not a multiple of the run
    (7, 104, 1280, {"run": 8, "threads": 256}),
    (5, 6, 1408, {"run": 2, "threads": 64}),  # W % 128 == 0: no pad column
    (3, 12, 160, {}),  # W % 16 == 0 < Wp: the pad column is a strip of its own
]


def coverage(T, H, W, g):
    """How many (block, thread, frame) tuples own each (frame, row, pixel),
    and each (frame, row) strip start, from the geometry alone."""
    count = np.zeros((T, H, W), np.int32)
    x_end = np.zeros((T, H), np.int32)  # one past the last column owned
    for run_idx in range(g.n_runs):
        for t in g.frames(run_idx, T):
            for part in range(g.n_parts):
                ys, xs = g.strips(part)
                for y0, x0 in zip(ys, xs):
                    count[t, y0 : min(H, y0 + 4), x0 : min(W, x0 + k2.STRIP)] += 1
                    x_end[t, y0 : min(H, y0 + 4)] = np.maximum(
                        x_end[t, y0 : min(H, y0 + 4)], x0 + k2.STRIP)
    return count, x_end


@pytest.mark.parametrize("T,H,W,kw", GEOMETRY_CASES)
def test_launch_geometry_covers_every_pixel_once(T, H, W, kw):
    g = k2.launch_geometry(T, H, W, **kw)
    count, x_end = coverage(T, H, W, g)
    np.testing.assert_array_equal(count, 1)
    Hp, Wp = k2.padded_hw(H, W)
    # the strips reach the pad column x = W when there is one, never past Wp
    assert np.all(x_end >= min(W + 1, Wp)) and np.all(x_end <= Wp)
    frames = [t for r in range(g.n_runs) for t in g.frames(r, T)]
    assert frames == list(range(T))
    spb = g.threads // 4  # four threads a strip, one row each
    assert g.n_parts * spb >= g.n_items > (g.n_parts - 1) * spb


def test_launch_geometry_fills_the_card_at_the_main_path_shape():
    g = k2.launch_geometry(32, 104, 1280)
    assert g.n_parts * g.n_runs >= 132
    with pytest.raises(ValueError):
        k2.launch_geometry(32, 104, 1280, run=k2.K2_RUN_MAX + 1)
    with pytest.raises(ValueError):
        k2.launch_geometry(32, 104, 1280, threads=100)


def emulate_k2(frames: np.ndarray, g, p=k2.ScanParams()) -> np.ndarray:
    """K2's algorithm in numpy: strips of 4 rows x 16 pixels, left neighbour
    from the strip before, prev from the frame before the run (frame 0 its
    own), f32 sums per strip, f64 partials per block summed in part order."""
    T, H, W, _ = frames.shape
    Hp, Wp = k2.padded_hw(H, W, p)
    lut = k2.gray_lut().numpy()
    rows, cols = g.n_bands * 4, g.n_strips * k2.STRIP
    gray = np.zeros((T, rows, cols + 1), np.float32)  # column 0: x = -1
    w = min(W, cols)
    gray[:, :H, 1 : w + 1] = lut_gray(lut, frames[:, :, :w])
    partials = np.zeros((T, g.n_parts, 4), np.float64)
    thr = np.float32(p.edge_threshold)
    for run_idx in range(g.n_runs):
        frames_of = g.frames(run_idx, T)
        for part in range(g.n_parts):
            ys, xs = g.strips(part)
            for t in frames_of:
                prev = gray[max(t - 1, 0)]
                for y0, x0 in zip(ys, xs):
                    cur = gray[t, y0 : y0 + 4, x0 : x0 + k2.STRIP + 1]
                    left, px = cur[:, :-1], cur[:, 1:]
                    gx = np.abs(px - left)
                    if x0 == 0:
                        gx[:, 0] = 0
                    diff = np.abs(px - prev[y0 : y0 + 4, x0 + 1 : x0 + k2.STRIP + 1])
                    edges = (gx > thr).reshape(4, 2, 8).sum(axis=(0, 2))
                    text = np.sum(np.float32(edges) / np.float32(32) > np.float32(p.moderate_threshold))
                    partials[t, part] += (gx.sum(dtype=np.float32), text,
                                          diff.sum(dtype=np.float32), px.sum(dtype=np.float32))
    sums = partials.sum(axis=1)
    out = (sums / (Hp * Wp)).astype(np.float32)
    n_cells = np.float32((Hp // 4) * (Wp // 8))
    out[:, 1] = np.float32(sums[:, 1]) * (np.float32(1) / n_cells)
    return out


@pytest.mark.parametrize("T,H,W,kw", [(5, 12, 256, {"run": 2}), (9, 37, 301, {"run": 4}),
                                     (3, 8, 128, {}), (4, 6, 136, {"run": 8, "threads": 64}),
                                     (3, 12, 160, {"run": 2})])
def test_k2_strip_algorithm_matches_plain(T, H, W, kw):
    rng = np.random.default_rng(H * W)
    f = rng.integers(0, 40, (T, H, W, 3)).astype(np.uint8)
    f[1:, H // 4 : H // 4 + 4, 3 : W - 2 : 3] = 250
    f[:, :, W - 1] = 255  # a bright last column: the pad edge at x = W counts
    g = k2.launch_geometry(T, H, W, **kw)
    got = emulate_k2(f, g)
    want = k2.frame_stats_plain(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[0, 2] == 0.0 and got[:, 1].max() > 0.0


@pytest.mark.parametrize("N,T,C", [(64, 80, 69), (3, 1, 21249), (2, 7000, 5), (5, 3, 700)])
def test_k1_plan_and_one_allocation(N, T, C):
    fused, lanes, threads = k1.decode_plan(T, C)
    assert fused == (C <= k1.FUSED_MAX_C and T <= k1.FUSED_MAX_T)
    assert lanes in (8, 16, 32) and threads in (128, 256)
    ids, mask, scores, ws = k1.alloc_outputs(N, T, "cpu")
    assert ids.shape == (N, T) and ids.dtype == torch.int32
    assert mask.shape == (N, T) and mask.dtype == torch.bool
    assert scores.shape == (N,) and scores.dtype == torch.float32
    assert ws.numel() == N * T * 8  # best int32 and prob f32
    parts = (ids, scores, ws, mask)  # in memory order
    base = ids.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in parts)
    spans = [(t.data_ptr() - base, t.data_ptr() - base + t.numel() * t.element_size())
             for t in parts]
    assert spans[0][0] == 0 and spans[-1][1] == ids.untyped_storage().nbytes()
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))  # packed, no overlap
    assert all(s % 4 == 0 for s, _ in spans[:-1])  # 4-byte aligned words


def test_k2_one_allocation():
    g = k2.launch_geometry(32, 104, 1280)
    partials, out = k2.alloc_outputs(32, g, "cpu")
    assert partials.dtype == torch.float64 and partials.numel() == 32 * g.n_parts * 4
    assert out.shape == (32, 4) and out.dtype == torch.float32
    assert out.untyped_storage().data_ptr() == partials.untyped_storage().data_ptr()
