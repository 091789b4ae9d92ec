#!/usr/bin/env python3
"""Profile one warm run of the port's main path on one CUDA card.

    python3 tools/profile_torch_main_path.py [--out chiprun_out/profile_main_path.json]

Drives ``SubtitleExtractor.run()`` (``extract --area --mode fast``, en) on
the smoke clip of ``vse_tpu_torch/assets/smoke`` (20 s of 1280x720 at
25 fps, composed in memory) twice: a cold run, then a warm run under
``torch.profiler`` with CPU and CUDA activities. Prints the card's name and
power limit, the warm run's pass seconds, the 15 device ops (kernels and
copies) with the most device time, and the device-busy share: the union of the device ops'
intervals over the profiled wall time. The Chrome trace goes to ``--out``
(git-ignored ``chiprun_out/`` by default). When the profiler records no
device time, it says so and exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_time(evt) -> float:
    """An event's own device time in us, across profiler versions."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "profile_main_path.json"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_main_path.py: CUDA is not available", file=sys.stderr)
        return 2
    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
    from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
    from vse_tpu_torch.video.synth import compose_clip, load_fixture, recipe_area

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    bands, recipe = load_fixture()
    cfg = VseConfig(language="en", mode="fast", word_segmentation=False)
    engine = OcrEngine(language="en", config=cfg, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        clip = compose_clip(bands, recipe, os.path.join(tmp, "smoke.avi"))
        SubtitleExtractor(clip, recipe_area(recipe), cfg, engine=engine, device="cuda").run()
        ex = SubtitleExtractor(clip, recipe_area(recipe), cfg, engine=engine, device="cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ex.run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
    print(f"warm run: pass seconds { {k: round(v, 4) for k, v in ex.pass_seconds.items()} }, "
          f"{wall / 1e6:.4f} s under the profiler", flush=True)

    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.time_range.end - e.time_range.start for e in dev)
    if not dev or total <= 0:
        print("the profiler recorded no device time on this machine", flush=True)
        return 1
    busy = busy_us((e.time_range.start, e.time_range.end) for e in dev)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_time(e) > 0]
    rows.sort(key=device_time, reverse=True)
    print(f"device ops: {len(dev)} launches, {total / 1e3:.3f} ms of device time; "
          f"device busy {busy / 1e3:.3f} ms of {wall / 1e3:.3f} ms wall = "
          f"{busy / wall:.1%} (idle {1 - busy / wall:.1%})", flush=True)
    print(f"{'device op':<60} {'calls':>6} {'device ms':>10} {'share':>7}")
    for e in rows[:15]:
        t = device_time(e)
        print(f"{e.key[:60]:<60} {e.count:>6} {t / 1e3:>10.3f} {t / total:>7.1%}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    prof.export_chrome_trace(args.out)
    print(f"trace: {os.path.relpath(args.out, ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
