"""Device-resident training loops (the port of
``vse_tpu/train/device_loop.py``): the dataset on the card, augmentation as
dense linear algebra on the card, and ``chunk`` optimizer steps between host
syncs.

- The pre-rendered dataset (u8 crops or frames, labels) crosses to the
  device once.
- Each step samples, augments, normalizes and updates on the device. The
  resampling augmentations are static-shape [H, H] / [W, W] operators whose
  *values* carry the random scale (a random-size ``cv2.resize`` chain as one
  product; ``torch.einsum`` / ``bmm``, as the JAX package's XLA products).
- The host reads the losses once a chunk (``chunk`` steps; the JAX package's
  ``lax.scan`` length) and calls ``log_cb`` then, and ``checkpoint_cb``
  every ``checkpoint_every`` steps and at the end.

JAX's ``jax.random`` stream cannot be reproduced in PyTorch, so the rec
augmentation is split into ``draw`` (every random value, from a
``torch.Generator`` on the device) and ``apply`` (the math), which the
parity test feeds with JAX's own draws. The generator is re-seeded from
``(seed, step)`` at every step, so a run resumed at a checkpoint draws what
the uninterrupted run draws.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

F32 = torch.float32


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=F32, device=device)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)`` with tensor bounds."""
    return torch.minimum(torch.maximum(x, _f32(lo, x.device)), _f32(hi, x.device))


def _bilinear_weights(n_dst_static: int, n_src_static: int, m_dst, m_src,
                      device=None) -> torch.Tensor:
    """[..., n_dst_static, n_src_static] bilinear resize operator whose
    active block is [m_dst, m_src] (values <= the static sizes; tensors of
    any batch shape, or numbers); rows and columns beyond it are zero. It
    samples as cv2.INTER_LINEAR: dst pixel d reads src coordinate
    (d + 0.5) * m_src / m_dst - 0.5."""
    if isinstance(m_dst, torch.Tensor):
        device = m_dst.device
    elif isinstance(m_src, torch.Tensor):
        device = m_src.device
    m_dst = _f32(m_dst, device)[..., None, None]
    m_src = _f32(m_src, device)[..., None, None]
    d = torch.arange(n_dst_static, dtype=F32, device=device)[:, None]
    j = torch.arange(n_src_static, dtype=F32, device=device)[None, :]
    s = (d + 0.5) * (m_src / m_dst) - 0.5
    j0 = torch.floor(s)
    frac = s - j0
    j0c = _clip(j0, 0.0, m_src - 1.0)
    j1c = _clip(j0 + 1.0, 0.0, m_src - 1.0)
    w = (j == j0c) * (1.0 - frac) + (j == j1c) * frac
    return w * (d < m_dst)


def resample_chain_matrix(n: int, m, device=None) -> torch.Tensor:
    """[n, n] operator equal to a bilinear resize n -> m, then m -> n."""
    up = _bilinear_weights(n, n, n, m, device)
    down = _bilinear_weights(n, n, m, n, device)
    return up @ down


def crop_expand_matrix(n: int, nh, y_off, device=None) -> torch.Tensor:
    """[n, n] operator equal to: resize n -> nh vertically, place at y_off,
    replicate the first / last row into the margins."""
    down = _bilinear_weights(n, n, nh, n, device)
    device = down.device
    i = torch.arange(n, device=device)[:, None]
    d = torch.arange(n, device=device)[None, :]
    src_row = torch.minimum(torch.maximum(i - torch.as_tensor(y_off, device=device),
                                          torch.zeros((), dtype=torch.long, device=device)),
                            torch.as_tensor(nh, device=device) - 1)
    return (d == src_row).to(F32) @ down


def interval_resize_matrix(h: int, a, b, device=None) -> torch.Tensor:
    """[..., h, h] operator resampling source rows [a, b) onto [0, h) with
    bilinear taps and edge-clamped reads (``a`` / ``b`` tensors of any batch
    shape, or numbers; b > a)."""
    if isinstance(a, torch.Tensor):
        device = a.device
    a = _f32(a, device)[..., None, None]
    b = _f32(b, device)[..., None, None]
    d = torch.arange(h, dtype=F32, device=device)[:, None]
    j = torch.arange(h, dtype=F32, device=device)[None, :]
    src = a + (d + 0.5) * (b - a) / h - 0.5
    j0 = torch.floor(src)
    frac = src - j0
    j0c = torch.clamp(j0, 0.0, h - 1.0)
    j1c = torch.clamp(j0 + 1.0, 0.0, h - 1.0)
    return (j == j0c) * (1.0 - frac) + (j == j1c) * frac


def ink_rows_batch(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample vertical ink extent (y0, y1) [B] as f32: rows whose mean
    horizontal gradient energy is over 12% of its range above the minimum
    (the rule of the engine's ink-tight crop); the whole height where fewer
    than 4 rows qualify."""
    h = x.shape[1]
    g = x.mean(dim=-1)
    e = torch.abs(g[:, :, 1:] - g[:, :, :-1]).mean(dim=2)
    lo = e.min(dim=1, keepdim=True).values
    rng = e.max(dim=1, keepdim=True).values - lo
    mask = (e - lo) > 0.12 * rng
    idx = torch.arange(h, device=x.device)[None, :]
    y0 = torch.where(mask, idx, torch.full_like(idx, h)).min(dim=1).values
    y1 = torch.where(mask, idx, torch.full_like(idx, -1)).max(dim=1).values
    ok = (y1 - y0) >= 3
    y0 = torch.where(ok, y0, torch.zeros_like(y0))
    y1 = torch.where(ok, y1, torch.full_like(y1, h - 1))
    return y0.to(F32), y1.to(F32)


def _uniform(gen, shape, lo, hi, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device, dtype=F32)


class RecAugment:
    """The rec crops' augmentation (``make_rec_augment``): photometric
    jitter, noise, a horizontal shift, a resample chain (p .5), the ink-band
    re-crop, and the coupled aspect fit with a black right pad (p .9)."""

    def __init__(self, h: int, w: int):
        self.h, self.w = h, w

    def draw(self, gen: Optional[torch.Generator], B: int, device) -> Dict[str, torch.Tensor]:
        """Every random value of one call, as tensors on ``device``. The
        comments name the JAX key each value comes from in
        ``vse_tpu/train/device_loop.py::make_rec_augment``."""
        h, w = self.h, self.w
        u = lambda shape, lo=0.0, hi=1.0: _uniform(gen, shape, lo, hi, device)  # noqa: E731
        return {
            "gain": u((B, 1, 1, 1), 0.7, 1.3),  # ks[0]
            "bias": u((B, 1, 1, 1), -30.0, 30.0),  # ks[1]
            "chan": u((B, 1, 1, 3), 0.9, 1.1),  # ks[2]
            "sigma": u((), 0.0, 8.0),  # ks[3]
            "noise": torch.randn((B, h, w, 3), generator=gen, device=device),  # ks[4]
            "shift": torch.randint(0, 9, (), generator=gen, device=device,
                                   dtype=torch.int32),  # ks[5]
            "sy": u((), 0.75, 1.0),  # ks[6]
            "mild": u((), 0.85, 1.05),  # ks[7]
            "resample_u": u(()),  # ks[8]
            "in_band_u": u((B,)),  # ks[9]
            "cjit": u((B,), -0.08, 0.08),  # ks[10]
            "hard": u((), 0.55, 0.85),  # ks[12]
            "hard_u": u(()),  # ks[13]
            "f_band": u((B,), 0.74, 0.90),  # ks[14]
            "f_tail": u((B,), 0.48, 0.74),  # ks[15]
            "aspect": u((B,), 0.9, 1.1),  # split(ks[11])[0]
            "fit_u": u((B,)),  # split(ks[11])[1]
            "narrow_u": u((B,)),  # split(ks[11])[2]
            "narrow": u((B,), 0.6, 1.0),  # split(ks[11])[3]
        }

    def apply(self, r: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """x: [B, h, w, 3] f32 in [0, 255] -> the augmented batch."""
        h, w = self.h, self.w
        dev = x.device
        x = (x - 127.5) * r["gain"] + 127.5 + r["bias"]
        x = x * r["chan"]
        x = x + r["sigma"] * r["noise"]
        # horizontal shift, the left edge replicating the original column 0
        cols = torch.arange(w, device=dev)
        rolled = x.index_select(2, torch.remainder(cols - r["shift"], w))
        x = torch.where((cols < r["shift"])[None, None, :, None], x[:, :, 0:1], rolled)
        x = torch.clamp(x, 0.0, 255.0)
        # resample chain: scale y in [.75, 1], x usually mild, 25% hard
        sx = r["sy"] * torch.where(r["hard_u"] < 0.25, r["hard"], r["mild"])
        dh = torch.clamp(torch.round(h * r["sy"]), min=8.0)
        dw = torch.clamp(torch.round(w * sx), min=16.0)
        my = resample_chain_matrix(h, dh)
        mx = resample_chain_matrix(w, dw)
        resampled = torch.einsum("ik,bkwc->biwc", my, x)
        resampled = torch.einsum("jw,bhwc->bhjc", mx, resampled)
        x = torch.where(r["resample_u"] < 0.5, resampled, x)
        # ink-anchored re-crop: the ink band resampled onto the full window
        y0, y1 = ink_rows_batch(x)
        ink = y1 - y0 + 1.0
        f = torch.where(r["in_band_u"] < 0.8, r["f_band"], r["f_tail"])
        span = ink / f
        cy = (y0 + y1 + 1.0) / 2.0 + r["cjit"] * span
        mg = interval_resize_matrix(h, cy - span / 2.0, cy + span / 2.0)
        x = torch.einsum("bik,bkwc->biwc", mg, x)
        # aspect fit of the ink columns, coupled to the y scale, black pad
        gc = x.mean(dim=-1)
        ec = torch.abs(gc[:, 1:, :] - gc[:, :-1, :]).mean(dim=1)
        loc = ec.min(dim=1, keepdim=True).values
        rngc = ec.max(dim=1, keepdim=True).values - loc
        maskc = (ec - loc) > 0.12 * rngc
        idxc = torch.arange(w, device=dev)[None, :]
        x1c = torch.where(maskc, idxc, torch.full_like(idxc, -1)).max(dim=1).values.to(F32)
        cw = torch.clamp(x1c + 5.0, 24.0, float(w))
        narrow = torch.where(r["narrow_u"] < 0.25, r["narrow"], torch.ones_like(r["narrow"]))
        s_fit = h / span * r["aspect"] * narrow
        dw2 = torch.clamp(cw * s_fit, 24.0, float(w))
        m_fit = _bilinear_weights(w, w, dw2, cw)
        fitted = torch.einsum("bjw,bhwc->bhjc", m_fit, x)
        return torch.where((r["fit_u"] < 0.9)[:, None, None, None], fitted, x)

    def __call__(self, gen: Optional[torch.Generator], x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.draw(gen, x.shape[0], x.device), x)


def make_rec_augment(h: int, w: int) -> RecAugment:
    return RecAugment(h, w)


def _step_generator(device, seed: int, step: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * 1_000_003 + step)
    return gen


def _chunk_len(i: int, steps: int, chunk: int, checkpoint_every: int) -> int:
    return min(chunk, steps - i,
               checkpoint_every - (i % checkpoint_every) or checkpoint_every)


def run_rec_device_loop(
    *,
    raw_imgs: np.ndarray,            # [N, h, w, 3] uint8
    labels: np.ndarray,              # [N, L] int32
    lengths: np.ndarray,             # [N] int32
    step_core: Callable,             # (images, labels, lengths) -> loss tensor
    steps: int, start_step: int, batch: int, seed: int,
    device="cuda",
    chunk: int = 200,
    checkpoint_every: int = 1000,
    checkpoint_cb: Optional[Callable[[int], None]] = None,
    log_cb: Optional[Callable[[int, float], None]] = None,
) -> List[float]:
    """Drive ``step_core`` for ``steps - start_step`` optimizer steps with
    the dataset on ``device``. The curriculum window (the clean-first prefix
    the samples are drawn from, all of it by 40% of the run) follows the
    global step. Returns every step's loss."""
    dev = torch.device(device)
    h, w = raw_imgs.shape[1], raw_imgs.shape[2]
    total = raw_imgs.shape[0]
    augment = make_rec_augment(h, w)
    t_up = time.time()
    imgs_dev = torch.from_numpy(np.ascontiguousarray(raw_imgs)).to(dev)
    labels_dev = torch.from_numpy(labels.astype(np.int64)).to(dev)
    lengths_dev = torch.from_numpy(lengths.astype(np.int64)).to(dev)
    print(f"[device-loop] dataset resident: {raw_imgs.nbytes / 1e9:.2f} GB "
          f"in {time.time() - t_up:.1f}s", flush=True)
    history: List[float] = []
    i = start_step
    while i < steps:
        n = _chunk_len(i, steps, chunk, checkpoint_every)
        losses = []
        for k in range(i, i + n):
            gen = _step_generator(dev, seed + 917, k)
            frac = min(1.0, k / max(1.0, steps * 0.4))
            window = min(max(batch * 8, int(total * frac)), total)
            idx = torch.randint(0, window, (batch,), generator=gen, device=dev)
            x = augment(gen, imgs_dev[idx].to(F32))
            x = (x / 255.0 - 0.5) / 0.5
            losses.append(step_core(x, labels_dev[idx], lengths_dev[idx]))
        i += n
        history += torch.stack(losses).tolist()
        if log_cb is not None:
            log_cb(i, history[-1])
        if checkpoint_cb is not None and (i % checkpoint_every == 0 or i >= steps):
            checkpoint_cb(i)
    return history


DET_MEAN = (0.485, 0.456, 0.406)
DET_STD = (0.229, 0.224, 0.225)
DET_GT_KEYS = ("gt_shrink", "gt_shrink_mask", "gt_thresh", "gt_thresh_mask")


def run_det_device_loop(
    *,
    ds: dict,                        # images [N, H, W, 3] u8; gt_* [N, H, W] f16
    step_core: Callable,             # (batch dict) -> (loss, metrics dict)
    steps: int, start_step: int, batch: int, seed: int,
    device="cuda",
    chunk: int = 100,
    checkpoint_every: int = 500,
    checkpoint_cb: Optional[Callable[[int], None]] = None,
    log_cb: Optional[Callable[[int, float, Dict[str, float]], None]] = None,
) -> List[float]:
    """Device-resident det training (the design of ``run_rec_device_loop``):
    the frames and their f16 label maps cross once; each step draws a batch,
    jitters gain, bias and noise, and normalizes on the device. Returns
    every step's loss."""
    dev = torch.device(device)
    n_total = ds["images"].shape[0]
    t_up = time.time()
    imgs_dev = torch.from_numpy(np.ascontiguousarray(ds["images"])).to(dev)
    gts_dev = {k: torch.from_numpy(np.asarray(ds[k], np.float16)).to(dev) for k in DET_GT_KEYS}
    print(f"[det device-loop] dataset resident "
          f"({sum(np.asarray(v).nbytes for v in ds.values()) / 1e9:.2f} GB) "
          f"in {time.time() - t_up:.1f}s", flush=True)
    mean = torch.tensor(DET_MEAN, dtype=F32, device=dev)
    std = torch.tensor(DET_STD, dtype=F32, device=dev)
    history: List[float] = []
    i = start_step
    while i < steps:
        n = _chunk_len(i, steps, chunk, checkpoint_every)
        losses, metrics = [], None
        for k in range(i, i + n):
            gen = _step_generator(dev, seed + 417, k)
            idx = torch.randint(0, n_total, (batch,), generator=gen, device=dev)
            x = imgs_dev[idx].to(F32)
            gain = _uniform(gen, (batch, 1, 1, 1), 0.75, 1.25, dev)
            bias = _uniform(gen, (batch, 1, 1, 1), -25.0, 25.0, dev)
            x = (x - 127.5) * gain + 127.5 + bias
            x = x + 5.0 * torch.randn(x.shape, generator=gen, device=dev)
            x = torch.clamp(x, 0.0, 255.0)
            hb = {"det_images": (x / 255.0 - mean) / std}
            for key, v in gts_dev.items():
                hb[key] = v[idx].to(F32)
            loss, metrics = step_core(hb)
            losses.append(loss)
        i += n
        history += torch.stack(losses).tolist()
        if log_cb is not None:
            log_cb(i, history[-1], {key: float(v) for key, v in metrics.items()})
        if checkpoint_cb is not None and (i % checkpoint_every == 0 or i >= steps):
            checkpoint_cb(i)
    return history
