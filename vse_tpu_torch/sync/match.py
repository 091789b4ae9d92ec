"""Normalized sqdiff template matching for audio alignment (the port of
``vse_tpu/sync/match.py``).

The reference's hot loop calls OpenCV's TM_SQDIFF_NORMED matcher on 1-D
audio (reference backend/sushi/wav.py:187). With template T (length M) and
image window I_x,

  sqdiff(x)      = sum(T^2) + sum(I_x^2) - 2 * corr(x)
  sqdiff_norm(x) = sqdiff(x) / sqrt(sum(T^2) * sum(I_x^2))

``match_template_numpy`` is the JAX package's f64 numpy matcher, copied as
it is: the default matcher, the reference's bit for bit.
``match_template_device`` is the counterpart of its device matcher: corr as
an f32 FFT cross-correlation (``torch.fft``, cuFFT on the card), the window
energies from a cumsum, the same power-of-two FFT lengths and the same
``+inf`` past the last valid offset. The JAX package computes it with XLA
ops outside any Pallas kernel, so a library FFT is its counterpart here.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch


def _sqdiff_normed_fft(image: torch.Tensor, template: torch.Tensor,
                       img_len: int, tpl_len: int, fft_len: int) -> torch.Tensor:
    """image, template: f32 [fft_len], zero-padded; the actual lengths as
    ints. Returns [fft_len] scores; entries from (img_len - tpl_len + 1) on
    are +inf."""
    fi = torch.fft.rfft(image, fft_len)
    ft = torch.fft.rfft(template, fft_len)
    corr = torch.fft.irfft(fi * torch.conj(ft), fft_len)  # corr[x] = sum I[x+j] T[j]
    csum2 = torch.cat([image.new_zeros(1), torch.cumsum(image * image, 0)])
    n = image.shape[0]
    idx = torch.arange(n, device=image.device)
    end = torch.clamp(idx + tpl_len, max=n)
    win_energy = csum2[end] - csum2[idx]
    t_energy = torch.sum(template * template)
    sq = t_energy + win_energy - 2.0 * corr[:n]
    denom = torch.sqrt(torch.clamp(t_energy * win_energy, min=1e-12))
    score = sq / denom
    return torch.where(idx < img_len - tpl_len + 1, score,
                       torch.full_like(score, float("inf")))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def match_template_device(image: np.ndarray, template: np.ndarray,
                          device: Union[str, torch.device] = "cuda") -> Tuple[float, int]:
    """(best_score, best_offset) of TM_SQDIFF_NORMED on ``device``, in f32.
    1-D inputs."""
    image = np.asarray(image, np.float32).ravel()
    template = np.asarray(template, np.float32).ravel()
    n, m = len(image), len(template)
    if m > n:
        raise ValueError("template longer than image")
    fft_len = _next_pow2(n + m)
    buf_i = np.zeros(fft_len, np.float32)
    buf_i[:n] = image
    buf_t = np.zeros(fft_len, np.float32)
    buf_t[:m] = template
    dev = torch.device(device)
    scores = _sqdiff_normed_fft(torch.from_numpy(buf_i).to(dev), torch.from_numpy(buf_t).to(dev),
                                n, m, fft_len)
    best = int(torch.argmin(scores).item())
    return float(scores[best].item()), best


def match_template_numpy(image: np.ndarray, template: np.ndarray) -> Tuple[float, int]:
    """Exact numpy reference (same math, direct FFT via numpy)."""
    image = np.asarray(image, np.float64).ravel()
    template = np.asarray(template, np.float64).ravel()
    n, m = len(image), len(template)
    fft_len = _next_pow2(n + m)
    fi = np.fft.rfft(image, fft_len)
    ft = np.fft.rfft(template, fft_len)
    corr = np.fft.irfft(fi * np.conj(ft), fft_len)[: n - m + 1]
    csum2 = np.concatenate([[0.0], np.cumsum(image * image)])
    win = csum2[m:] - csum2[: n - m + 1]
    t_energy = float(np.sum(template * template))
    sq = t_energy + win - 2.0 * corr
    denom = np.sqrt(np.maximum(t_energy * win, 1e-12))
    scores = sq / denom
    best = int(np.argmin(scores))
    return float(scores[best]), best
