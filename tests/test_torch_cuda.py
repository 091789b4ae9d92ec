"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: ids, masks and text_cells exact; scores
and float stats rtol 1e-5 / atol 1e-6. Both kernels sum in a fixed order,
so two runs on the same input are bit-equal.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vse_tpu_torch.kernels import ctc_decode as k1
from vse_tpu_torch.kernels import keyframe as k2

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def logits_with_ties(n, t, c, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, t, c)) * 4.0).astype(np.float32)
    for row, shift in ((0, 7), (1, c - 3)):
        best = x[row].argmax(-1)
        x[row, np.arange(t), (best + shift) % c] = x[row].max(-1)
    x[2:4, :, 0] = x[2:4].max(-1) + 5.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("t", [1, 80])
@pytest.mark.parametrize("c", [1, 69, 1000, 21249])
def test_k1_cuda_matches_plain(cuda, c, t):
    x = logits_with_ties(64, t, c, seed=c + t).to(cuda)
    before = k1.launches
    ids, mask, scores = k1.ctc_greedy_decode(x)
    assert k1.launches == before + 1
    ids_p, mask_p, scores_p = k1.collapse(*k1.argmax_lse_plain(x))
    assert torch.equal(ids, ids_p) and torch.equal(mask, mask_p)
    torch.testing.assert_close(scores, scores_p, rtol=1e-5, atol=1e-6)
    assert torch.all(scores[2:4] == 1.0)
    again = k1.greedy_decode_cuda(x)
    assert all(torch.equal(a, b) for a, b in zip((ids, mask, scores), again))


def test_k1_cuda_unaligned_rows(cuda):
    """A view that starts one step in: no row is 16-byte aligned."""
    x = logits_with_ties(9, 5, 2051, seed=1).to(cuda).reshape(45, 2051)[1:41]
    x = x.reshape(8, 5, 2051)
    ids, mask, scores = k1.greedy_decode_cuda(x)
    ids_p, mask_p, scores_p = k1.collapse(*k1.argmax_lse_plain(x))
    assert torch.equal(ids, ids_p) and torch.equal(mask, mask_p)
    torch.testing.assert_close(scores, scores_p, rtol=1e-5, atol=1e-6)


def device_ops(fn):
    """Names of the device operations (kernels, copies, memsets) that one
    call of ``fn`` issues, with host syncs raising inside it."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("c,n_kernels", [(69, 1), (21249, 2)])
def test_k1_decode_issues_only_its_kernels(cuda, c, n_kernels):
    x = logits_with_ties(8, 80, c, seed=3).to(cuda)
    names = device_ops(lambda: k1.ctc_greedy_decode(x))
    assert len(names) == n_kernels and all("ctc_" in n for n in names), names


def test_k2_issues_only_its_kernel(cuda):
    x = torch.zeros((32, 104, 1280, 3), dtype=torch.uint8, device=cuda)
    names = device_ops(lambda: k2.scan_stats_u8(x))
    assert len(names) == 1 and "keyframe_stats" in names[0], names


K2_SHAPES = [
    (32, 104, 1280),  # the main path's band
    (32, 37, 301),  # ragged
    (1, 8, 128),
    (5, 38, 300),  # W % 16 != 0 and H % 4 != 0
    (1, 104, 1280),  # T = 1
    (13, 104, 1280),  # T not a multiple of the run
    (3, 12, 160),  # W % 16 == 0 < Wp: 16-byte loads and a pad-column strip
]


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_cuda_matches_plain(cuda, shape):
    t, h, w = shape
    rng = np.random.default_rng(h * w)
    f = rng.integers(0, 40, (t, h, w, 3)).astype(np.uint8)
    f[t // 2 :, h // 4 : h // 4 + 6, 4 : w - 4 : 3] = 250
    x = torch.from_numpy(f).to(cuda)
    got = k2.frame_stats_cuda(x)
    want = k2.frame_stats_plain(x)
    assert torch.equal(got[:, 1], want[:, 1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert got[0, 2].item() == 0.0
    before = k2.launches
    again = k2.scan_stats_u8(x)
    assert k2.launches == before + 1
    assert torch.equal(got, again)


@pytest.mark.parametrize("threads,run", [(32, 1), (64, 3), (128, 8), (256, 2)])
def test_k2_cuda_geometries_agree(cuda, threads, run):
    rng = np.random.default_rng(threads + run)
    x = torch.from_numpy(rng.integers(0, 256, (11, 20, 160, 3)).astype(np.uint8)).to(cuda)
    g = k2.launch_geometry(11, 20, 160, threads=threads, run=run)
    partials, got = k2.alloc_outputs(11, g, cuda)
    k2.launch(x, g, k2.ScanParams(), partials, got)
    want = k2.frame_stats_plain(x)
    assert torch.equal(got[:, 1], want[:, 1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        k1.greedy_decode_cuda(torch.zeros((2, 3, 4), dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError):
        k1.greedy_decode_cuda(torch.zeros((2, 4, 3), device=cuda).transpose(1, 2))
    with pytest.raises(TypeError):
        k2.frame_stats_cuda(torch.zeros((2, 8, 8, 3), device=cuda))
    with pytest.raises(ValueError):
        k2.frame_stats_cuda(torch.zeros((2, 8, 16, 3), dtype=torch.uint8, device=cuda)[:, :, ::2])
    with pytest.raises(ValueError):
        k2.frame_stats_cuda(torch.zeros((2, 8, 16, 3), dtype=torch.uint8, device=cuda),
                            k2.ScanParams(segment_height=3))
