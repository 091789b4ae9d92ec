#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vse_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each timed; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit (nvidia-smi), torch/CUDA
   versions, and whether OpenCV and ninja exist (printed only, never needed);
2. build: the CUDA kernels of ``vse_tpu_torch/csrc`` with one nvcc call;
3. kernel parity on the card: K1 (greedy-CTC argmax/softmax-prob) and K2
   (keyframe stats) against their plain PyTorch versions on the same inputs,
   with each kernel's median time, its device-memory bound and the plain
   version's time;
4. the main path, ``extract --area --mode fast`` for ``en`` through
   ``SubtitleExtractor(...).run()`` on a 20 s 1280x720 25 fps clip composed
   in memory from ``vse_tpu_torch/assets/smoke``, with the real PP-OCRv3
   mobile det weights and the exported en rec head. The SRT must equal the
   committed reference (the JAX package's CLI on the CPU for the same
   frames) and both kernels must have launched on the path.

The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
REPS = 30


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, rtol, atol):
    import torch

    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = (got - want).abs().max().item()
        raise AssertionError(f"{name}: max abs err {err} beyond rtol {rtol} atol {atol}")
    return (got - want).abs().max().item() if got.numel() else 0.0


def k1_logits(N, T, C, seed):
    """Random logits with exact ties (the max copied to a later and to an
    earlier class) and all-blank rows (class 0 dominant at every step)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, T, C), generator=g) * 4.0
    best = x.argmax(-1)
    top = x.max(-1).values
    x[0, :, :].scatter_(1, ((best[0] + 7) % C)[:, None], top[0][:, None])
    x[1, :, :].scatter_(1, ((best[1] + C - 3) % C)[:, None], top[1][:, None])
    x[2:5, :, 0] = x[2:5].max(-1).values + 5.0
    return x.cuda()


def kernel_parity():
    import torch

    from vse_tpu_torch.kernels import ctc_decode as k1
    from vse_tpu_torch.kernels import keyframe as k2
    from vse_tpu_torch.video.synth import compose_frames, load_fixture

    rows = {}
    # K1 at the main path's shape ([8 frames x 8 boxes, 80, 69]) and the
    # 21,249-class heads'
    k1_err = 0.0
    for i, (N, T, C) in enumerate([(64, 80, 69), (64, 80, 21249)]):
        x = k1_logits(N, T, C, seed=i)
        best_c, prob_c = k1.argmax_lse_cuda(x)
        best_p, prob_p = k1.argmax_lse_plain(x)
        if not torch.equal(best_c, best_p):
            raise AssertionError(f"K1 {N,T,C}: argmax differs from the plain version")
        k1_err = max(k1_err, check_close(f"K1 {N,T,C} prob", prob_c, prob_p, 1e-5, 1e-6))
        ids_c, mask_c, sc_c = k1.collapse(best_c, prob_c)
        ids_p, mask_p, sc_p = k1.collapse(best_p, prob_p)
        if not (torch.equal(ids_c, ids_p) and torch.equal(mask_c, mask_p)):
            raise AssertionError(f"K1 {N,T,C}: ids/mask differ")
        if not torch.all(sc_c[2:5] == 1.0):
            raise AssertionError("K1: an all-blank row must score 1.0")
        k1_err = max(k1_err, check_close(f"K1 {N,T,C} scores", sc_c, sc_p, 1e-5, 1e-6))
        ms = time_ms(lambda: k1.argmax_lse_cuda(x))
        plain = time_ms(lambda: k1.argmax_lse_plain(x))
        bnd, by = bound_ms(N * T * C * 4 + N * T * 8, 4.0 * N * T * C)
        print(f"K1 [{N},{T},{C}]: {ms:.4f} ms (bound {bnd * 1e3:.2f} us by {by}), "
              f"plain {plain:.4f} ms; ids/mask exact", flush=True)
        if i == 0:
            rows["K1"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by)
    rows["K1"]["max_abs_err"] = k1_err

    # K2 on the fixture's text band (the main path's [32, 104, 1280, 3]),
    # on random pixels at that shape, and on a ragged shape
    bands, recipe = load_fixture()
    y0, y1, x0, x1 = recipe["area"]
    clip = compose_frames(bands, recipe, n_frames=64)
    band = torch.from_numpy(clip[32:64, y0:y1, x0:x1].copy()).cuda()
    g = torch.Generator().manual_seed(7)
    cases = [
        ("fixture band", band),
        ("random", torch.randint(0, 256, tuple(band.shape), generator=g,
                                 dtype=torch.uint8).cuda()),
        ("ragged", torch.randint(0, 256, (32, 37, 301, 3), generator=g,
                                 dtype=torch.uint8).cuda()),
    ]
    k2_err = 0.0
    for label, fr in cases:
        got = k2.frame_stats_cuda(fr)
        want = k2.frame_stats_plain(fr)
        if not torch.equal(got[:, 1], want[:, 1]):
            raise AssertionError(f"K2 {label}: text_cells differ")
        if not torch.all(got[::32, 2] == 0):
            raise AssertionError(f"K2 {label}: the batch's first diff must be 0")
        k2_err = max(k2_err, check_close(f"K2 {label}", got, want, 1e-5, 1e-6))
        print(f"K2 {label} {list(fr.shape)}: stats within rtol 1e-5, text_cells "
              f"exact (first frame {got[0].tolist()})", flush=True)
    T, H, W, _ = band.shape
    ms = time_ms(lambda: k2.frame_stats_cuda(band))
    plain = time_ms(lambda: k2.frame_stats_plain(band))
    Hp, Wp = k2.padded_hw(H, W)
    bnd, by = bound_ms(T * H * W * 3 + T * 16, 20.0 * T * Hp * Wp)
    print(f"K2 {list(band.shape)}: {ms:.4f} ms (bound {bnd * 1e3:.2f} us by {by}), "
          f"plain {plain:.4f} ms", flush=True)
    rows["K2"] = dict(ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                      max_abs_err=k2_err)
    return rows


def main_path(card: str):
    import torch

    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.kernels import ctc_decode as k1
    from vse_tpu_torch.kernels import keyframe as k2
    from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
    from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
    from vse_tpu_torch.video.synth import SMOKE_FIXTURE, compose_clip, load_fixture, recipe_area

    bands, recipe = load_fixture()
    with open(os.path.join(SMOKE_FIXTURE, "reference.srt"), encoding="utf-8") as f:
        reference = f.read()
    cfg = VseConfig(language="en", mode="fast", word_segmentation=False)
    t0 = time.perf_counter()
    engine = OcrEngine(language="en", config=cfg, device="cuda")
    print(f"engine load: {time.perf_counter() - t0:.2f} s", flush=True)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        clip = compose_clip(bands, recipe, os.path.join(tmp, "smoke.avi"))
        n_batches = -(-len(clip.frames) // 32)
        for run in ("cold", "warm"):
            ex = SubtitleExtractor(clip, recipe_area(recipe), cfg, engine=engine,
                                   device="cuda")
            torch.cuda.reset_peak_memory_stats()
            k1.launches = 0
            k2.launches = 0
            srt_path = ex.run()
            launches = {"K1": k1.launches, "K2": k2.launches}
            with open(srt_path, encoding="utf-8") as f:
                got = f.read()
            secs = {k: round(v, 4) for k, v in ex.pass_seconds.items()}
            print(f"main path ({run}) on {card}: pass seconds {secs}, "
                  f"{ex.n_spans} spans, {ex.n_samples} OCR samples, launches "
                  f"{launches}, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
            if got != reference:
                raise AssertionError(
                    f"SRT differs from the reference:\n--- got\n{got}\n--- want\n{reference}")
            if launches["K2"] != n_batches:
                raise AssertionError(f"K2 launched {launches['K2']} times, want {n_batches}")
            if launches["K1"] < 1:
                raise AssertionError("K1 was never launched on the main path")
    cues = reference.strip().count("-->")
    print(f"SRT equals the JAX reference ({cues} cues, timings and text)", flush=True)
    return launches


def main() -> int:
    t_all = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "vse_tpu_torch")):
        print("chip_smoke.py: the vse_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, cv2 {'present' if importlib.util.find_spec('cv2') else 'absent'}, "
          f"ninja {'present' if shutil.which('ninja') else 'absent'}", flush=True)
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    phase("environment", t0)

    from vse_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    print(f"built {os.path.relpath(info.path, here)} in {info.seconds:.2f} s", flush=True)
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip().split("ptxas info    : ")[-1], flush=True)
    phase("build", t0)

    t0 = time.perf_counter()
    rows = kernel_parity()
    phase("kernel parity", t0)

    t0 = time.perf_counter()
    launches = main_path(card)
    phase("main path", t0)

    meta = {
        "K1": ("ctc_argmax_lse", "vse_tpu_torch/csrc/ctc_decode.cu",
               "vse_tpu/kernels/ctc_decode.py:26"),
        "K2": ("keyframe_stats", "vse_tpu_torch/csrc/keyframe.cu",
               "vse_tpu/kernels/keyframe.py:117"),
    }
    kernels = []
    for key, (name, src, replaces) in meta.items():
        r = rows[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[key], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    print(f"[phase] total: {time.perf_counter() - t_all:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
