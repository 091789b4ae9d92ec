#!/usr/bin/env python3
"""Profile one warm run of one of the port's paths on one CUDA card.

    python3 tools/profile_torch_main_path.py [--path keyframe|fps|train_rec|train_det] \\
        [--language en|ch|japan|chinese_cht] [--mode fast|auto|accurate] \\
        [--out TRACE.json]

Drives ``SubtitleExtractor.run()`` with the default config (word
segmentation on) in ``--mode`` (default fast; accurate with an area runs
per-frame detection, auto the keyframe scan with the server det, both on
the server det) for ``--language`` (default en) on a smoke clip of
``vse_tpu_torch/assets/smoke`` (20 s of 1280x720 at 25 fps, composed in
memory): ``keyframe`` (default) the clip with a subtitle area (``extract
--area``: ``recipe.json``, for ch ``recipe_ch.json``), ``fps`` a no-area
clip (``extract`` with no area: ``recipe_fps.json``, for ch
``recipe_ch_fps_short.json``). japan and chinese_cht have a keyframe clip
only (their key of ``recipe_scripts.json``).
Two runs: a cold run, then a warm run under ``torch.profiler`` with CPU and
CUDA activities. Prints the card's name and
power limit, the warm run's pass seconds, the 15 device ops (kernels and
copies) with the most device time, and the device-busy share: the union of the device ops'
intervals over the profiled wall time. The Chrome trace goes to ``--out``
(git-ignored ``chiprun_out/`` by default). When the profiler records no
device time, it says so and exits non-zero.

``--path train_rec`` / ``train_det`` profile training instead: the device
loop (``vse_tpu_torch/train/device_loop.py``) on the committed dataset
(``assets/smoke/train_rec_en.npz``, batch 64 at 48 x 320;
``train_det_en.npz``, batch 16 at 256 x 448) from a fresh init with the
optimizer of a 300-step run, 20 warm-up steps, then 20 steps profiled;
it prints ms a step besides the rest.
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


# the smoke clips of each language: (keyframe, fps)
RECIPES = {"en": ("recipe.json", "recipe_fps.json"),
           "ch": ("recipe_ch.json", "recipe_ch_fps_short.json"),
           "japan": ("japan", None), "chinese_cht": ("chinese_cht", None)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=["keyframe", "fps", "train_rec", "train_det"],
                    default="keyframe")
    ap.add_argument("--language", choices=sorted(RECIPES), default="en")
    ap.add_argument("--mode", choices=["fast", "auto", "accurate"], default="fast")
    ap.add_argument("--out", default=None,
                    help="trace path (default: profile_<language>_<path>[_<mode>].json "
                         "in the git-ignored output directory)")
    args = ap.parse_args()
    suffix = "" if args.mode == "fast" else f"_{args.mode}"
    out = args.out or os.path.join(ROOT, "chiprun_out",
                                   f"profile_{args.language}_{args.path}{suffix}.json")
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_main_path.py: CUDA is not available", file=sys.stderr)
        return 2
    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
    from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
    from vse_tpu_torch.video.synth import (
        compose_clip, load_fixture, load_script_fixture, recipe_area,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.path.startswith("train_"):
        run, label = training_run(args.path)
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        print(f"{label}: {TRAIN_STEPS} steps in {wall / 1e6:.4f} s under the profiler, "
              f"{wall / 1e3 / TRAIN_STEPS:.3f} ms a step", flush=True)
        return summarize(prof, wall, out)
    name = RECIPES[args.language][args.path == "fps"]
    if name is None:
        print(f"profile_torch_main_path.py: {args.language} has no {args.path} clip",
              file=sys.stderr)
        return 2
    if name.endswith(".json"):
        bands, recipe = load_fixture(recipe=name)
    else:
        bands, recipe = load_script_fixture(name)
    cfg = VseConfig(language=args.language, mode=args.mode)
    engine = OcrEngine(language=args.language, mode=args.mode, config=cfg, device="cuda")
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
    print(f"{args.language} {args.path} path, mode {args.mode}, det {engine.spec.det_variant}, warm run: pass seconds { {k: round(v, 4) for k, v in ex.pass_seconds.items()} }, "
          f"{wall / 1e6:.4f} s under the profiler", flush=True)
    return summarize(prof, wall, out)


TRAIN_STEPS = 20


def training_run(path: str):
    """(a callable running TRAIN_STEPS steps of the path's device loop,
    its label). The model and optimizer persist across calls."""
    import numpy as np

    from vse_tpu_torch.device import resolve_device
    from vse_tpu_torch.models.crnn import CRNNRecognizer
    from vse_tpu_torch.models.db_detector import DBDetector
    from vse_tpu_torch.train import optim
    from vse_tpu_torch.train import pretrain as P
    from vse_tpu_torch.train.device_loop import run_det_device_loop, run_rec_device_loop
    from vse_tpu_torch.video.synth import SMOKE_FIXTURE

    dev = resolve_device("cuda")
    kw = dict(steps=TRAIN_STEPS, start_step=0, seed=0, device=dev, chunk=TRAIN_STEPS)
    if path == "train_rec":
        with np.load(os.path.join(SMOKE_FIXTURE, "train_rec_en.npz")) as z:
            images, texts = z["images"], [str(t) for t in z["texts"]]
        charset = P._rec_train_charset("en", False, True)
        labels, lengths = P.encode_labels(charset, texts, 24)
        model = P.flax_init(CRNNRecognizer(charset.vocab_size), 0).to(dev)
        opt = optim.Optimizer(P.rec_optimizer(1e-3, 100, 300), P.trainable(model))
        return (lambda: run_rec_device_loop(
            raw_imgs=images, labels=labels, lengths=lengths, batch=64,
            step_core=lambda x, a, b: P.rec_step(model, opt, x, a, b), **kw),
            "train_rec, batch 64 at 48 x 320")
    with np.load(os.path.join(SMOKE_FIXTURE, "train_det_en.npz")) as z:
        ds = {k: z[k] for k in z.files}
    model = P.flax_init(DBDetector("mobile", train_outputs=True), 0).to(dev)
    opt = optim.Optimizer(P.det_optimizer(5e-4, 300), P.trainable(model))
    return (lambda: run_det_device_loop(ds=ds, batch=16,
                                        step_core=lambda b: P.det_step(model, opt, b), **kw),
            "train_det, batch 16 at 256 x 448")


def summarize(prof, wall: float, out: str) -> int:
    from torch.autograd import DeviceType

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
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    prof.export_chrome_trace(out)
    print(f"trace: {os.path.relpath(out, ROOT)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
