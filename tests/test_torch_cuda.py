"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: ids, masks and text_cells exact; scores
and float stats rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("c", [69, 21249])
def test_k1_cuda_matches_plain(cuda, c):
    x = logits_with_ties(64, 80, c, seed=c).to(cuda)
    best, prob = k1.argmax_lse_cuda(x)
    best_p, prob_p = k1.argmax_lse_plain(x)
    assert torch.equal(best, best_p)
    torch.testing.assert_close(prob, prob_p, rtol=1e-5, atol=1e-6)
    before = k1.launches
    ids, mask, scores = k1.ctc_greedy_decode(x)
    assert k1.launches == before + 1
    ids_p, mask_p, scores_p = k1.collapse(best_p, prob_p)
    assert torch.equal(ids, ids_p) and torch.equal(mask, mask_p)
    torch.testing.assert_close(scores, scores_p, rtol=1e-5, atol=1e-6)
    assert torch.all(scores[2:4] == 1.0)


@pytest.mark.parametrize("shape", [(32, 104, 1280), (32, 37, 301), (1, 8, 128)])
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
    k2.scan_stats_u8(x)
    assert k2.launches == before + 1


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        k1.argmax_lse_cuda(torch.zeros((2, 3, 4), dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError):
        k1.argmax_lse_cuda(torch.zeros((2, 4, 3), device=cuda).transpose(1, 2))
    with pytest.raises(TypeError):
        k2.frame_stats_cuda(torch.zeros((2, 8, 8, 3), device=cuda))
    with pytest.raises(ValueError):
        k2.frame_stats_cuda(torch.zeros((2, 8, 16, 3), dtype=torch.uint8, device=cuda)[:, :, ::2])
