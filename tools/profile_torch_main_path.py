#!/usr/bin/env python3
"""Profile one warm run of one of the port's paths on one CUDA card.

    python3 tools/profile_torch_main_path.py [--path keyframe|fps|train_rec|train_det] \\
        [--language en|ch|japan|chinese_cht] [--mode fast|auto|accurate] \\
        [--video FILE [--area YMIN,YMAX,XMIN,XMAX]] [--out TRACE.json]

Drives ``SubtitleExtractor.run()`` with the default config (word
segmentation on) in ``--mode`` (default fast; accurate with an area runs
per-frame detection, auto the keyframe scan with the server det, both on
the server det) for ``--language`` (default en) on a smoke clip of
``vse_tpu_torch/assets/smoke`` (20 s of 1280x720 at 25 fps, composed in
memory): ``keyframe`` (default) the clip with a subtitle area (``extract
--area``: ``recipe.json``, for ch ``recipe_ch.json``), ``fps`` a no-area
clip (``extract`` with no area: ``recipe_fps.json``, for ch
``recipe_ch_fps_short.json``). japan and chinese_cht have a keyframe clip
only (their key of ``recipe_scripts.json``). ``--video`` profiles a video
file instead, decoded by OpenCV as a user's file is (such as a clip of the
benchmark's pool under ``portbench/.cache/``), with ``--area`` its subtitle
area (no area: the fps strategy); an in-memory clip costs its decode thread
next to nothing.
Two runs: a cold run, then a warm run under ``utils/tracing.trace_context``
(``torch.profiler`` with CPU and CUDA activities, the program's recorder
on). Prints the card's name and power limit, the warm run's pass seconds,
the 15 device ops (kernels and copies) with the most device time, the
device-busy share (the union of the device ops' intervals over the
profiled wall time, ``portbench/devtrace.py::merged_busy``), the device's
idle seconds by the innermost program span the ``extract`` thread was in,
and each thread's seconds by span name (``total`` with its children,
``self`` without; the ``*wait`` spans are waits). The Chrome trace goes to
``--out`` (by default a file in the repo's git-ignored output directory).
When the profiler records no device time, it says so and exits non-zero.

``--path train_rec`` / ``train_det`` profile training instead: the device
loop (``vse_tpu_torch/train/device_loop.py``) on the committed dataset
(``assets/smoke/train_rec_en.npz``, batch 64 at 48 x 320;
``train_det_en.npz``, batch 16 at 256 x 448) from a fresh init with the
optimizer of a 300-step run, 20 warm-up steps, then 20 steps profiled;
it prints ms a step besides the rest.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import subprocess
import sys
import tempfile
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


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
    ap.add_argument("--video", default=None, help="a video file to profile instead of a smoke clip")
    ap.add_argument("--area", default=None, help="the video's subtitle area: ymin,ymax,xmin,xmax")
    ap.add_argument("--out", default=None,
                    help="trace path (default: profile_<language>_<path>[_<mode>].json "
                         "in the git-ignored output directory)")
    args = ap.parse_args()
    suffix = "" if args.mode == "fast" else f"_{args.mode}"
    out = args.out or os.path.join(ROOT, "chiprun_out",
                                   f"profile_{args.language}_{args.path}{suffix}.json")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "portbench")]
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_main_path.py: CUDA is not available", file=sys.stderr)
        return 2
    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.core.subtitle_area import SubtitleArea
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
        window = profiled(run, out)
        wall = (window[1] - window[0]) / 1e9
        print(f"{label}: {TRAIN_STEPS} steps in {wall:.4f} s under the profiler, "
              f"{wall * 1e3 / TRAIN_STEPS:.3f} ms a step", flush=True)
        return summarize(out, window)
    if args.video:
        bands = recipe = None
        area = SubtitleArea(*(int(v) for v in args.area.split(","))) if args.area else None
    else:
        name = RECIPES[args.language][args.path == "fps"]
        if name is None:
            print(f"profile_torch_main_path.py: {args.language} has no {args.path} clip",
                  file=sys.stderr)
            return 2
        if name.endswith(".json"):
            bands, recipe = load_fixture(recipe=name)
        else:
            bands, recipe = load_script_fixture(name)
        area = recipe_area(recipe)
    cfg = VseConfig(language=args.language, mode=args.mode)
    engine = OcrEngine(language=args.language, mode=args.mode, config=cfg, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        clip = args.video or compose_clip(bands, recipe, os.path.join(tmp, "smoke.avi"))
        SubtitleExtractor(clip, area, cfg, engine=engine, device="cuda").run()
        ex = SubtitleExtractor(clip, area, cfg, engine=engine, device="cuda")
        torch.cuda.synchronize()
        window = profiled(ex.run, out)
    path = os.path.basename(args.video) if args.video else f"{args.path} path"
    print(f"{args.language} {path}, mode {args.mode}, det {engine.spec.det_variant}, warm run: pass seconds { {k: round(v, 4) for k, v in ex.pass_seconds.items()} }, "
          f"{(window[1] - window[0]) / 1e9:.4f} s under the profiler", flush=True)
    return summarize(out, window)


def profiled(run, out: str):
    """Run ``run()`` once under ``trace_context`` with the program's
    recorder on (emptied first), its Chrome trace moved to ``out``; returns
    the run's (start, end) on the profiler's clock (ns)."""
    import torch

    from vse_tpu_torch.utils import tracing

    tracing.clear()
    with tempfile.TemporaryDirectory() as tmp:
        with tracing.trace_context(tmp) as path:
            t0 = tracing.now_ns()
            run()
            torch.cuda.synchronize()
            t1 = tracing.now_ns()
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        os.replace(path, out)
    return t0, t1


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


def summarize(out: str, window) -> int:
    """Print the device ops, the busy share, the idle seconds by program
    span and each thread's span seconds of the run in ``window``, from the
    Chrome trace at ``out`` and the program's recorder."""
    import devtrace
    from vse_tpu_torch.utils import tracing

    with open(out, encoding="utf-8") as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    dev = [(e["name"], base + round(e["ts"] * 1000), base + round((e["ts"] + e["dur"]) * 1000), 0)
           for e in trace["traceEvents"] if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    total = sum(b - a for _, a, b, _ in dev)
    if not dev or total <= 0:
        print("the profiler recorded no device time on this machine", flush=True)
        return 1
    profile = {"device": dev, "launches": [], "notes": [("clip#0", *window)]}
    busy_iv = devtrace.merged_busy(profile)
    busy, wall = sum(b - a for a, b in busy_iv), window[1] - window[0]
    per, calls = defaultdict(int), defaultdict(int)
    for name, a, b, _ in dev:
        per[name] += b - a
        calls[name] += 1
    print(f"device ops: {len(dev)} launches, {total / 1e6:.3f} ms of device time; "
          f"device busy {busy / 1e6:.3f} ms of {wall / 1e6:.3f} ms wall = "
          f"{busy / wall:.1%} (idle {1 - busy / wall:.1%})", flush=True)
    print(f"{'device op':<60} {'calls':>6} {'device ms':>10} {'share':>7}")
    for name, t in sorted(per.items(), key=lambda kv: -kv[1])[:15]:
        print(f"{name[:60]:<60} {calls[name]:>6} {t / 1e6:>10.3f} {t / total:>7.1%}")
    print_program_spans(tracing.spans(), busy_iv, window)
    print(f"trace: {os.path.relpath(out, ROOT)}", flush=True)
    return 0


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def _minus(a: int, b: int, holes):
    """[a, b) less the merged, sorted ``holes``."""
    out, at = [], a
    for x, y in holes:
        if y <= at or x >= b:
            continue
        if x > at:
            out.append((at, x))
        at = max(at, y)
    if at < b:
        out.append((at, b))
    return out


def _idle_clock(idle):
    """t -> idle time in the run up to t, for merged, sorted ``idle``."""
    starts = [a for a, _ in idle]
    before = [0]
    for a, b in idle:
        before.append(before[-1] + b - a)

    def upto(t: int) -> int:
        i = bisect.bisect_right(starts, t) - 1
        return 0 if i < 0 else before[i] + min(t, idle[i][1]) - idle[i][0]

    return upto


def print_program_spans(spans, busy_iv, window) -> None:
    """The device's idle time by the innermost span of the ``extract``
    thread (a span's own time less its children's), and each thread's
    seconds by span name."""
    w0, w1 = window
    spans = [s for s in spans if s.end_ns > w0 and s.start_ns < w1]
    if not spans:
        print("the program recorded no spans in the run", flush=True)
        return
    children = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append((s.start_ns, s.end_ns))
    own = {s.id: _minus(max(s.start_ns, w0), min(s.end_ns, w1), _merge(children[s.id]))
           for s in spans}
    edges = [w0] + [x for iv in busy_iv for x in iv] + [w1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    idle_total = sum(b - a for a, b in idle)
    upto = _idle_clock(idle)
    roots = [s for s in spans if s.name == "extract"]
    if roots:
        main = roots[0].thread
        by_name = defaultdict(int)
        for s in spans:
            if s.thread == main:
                by_name[s.name] += sum(upto(b) - upto(a) for a, b in own[s.id])
        by_name["(outside the spans)"] = idle_total - sum(by_name.values())
        print(f"device idle {idle_total / 1e9:.4f} s, by the extract thread's innermost span:")
        print(f"  {'span':<24} {'idle s':>9} {'share':>7}")
        for name, t in sorted(by_name.items(), key=lambda kv: -kv[1]):
            if t > 0:
                print(f"  {name:<24} {t / 1e9:>9.4f} {t / idle_total:>7.1%}")
    roles = {}
    for s in spans:
        if s.name == "extract":
            roles[s.thread] = "main"
        elif s.name == "decode.read":
            roles.setdefault(s.thread, "decode")
        elif s.name == "feed.stage":
            roles.setdefault(s.thread, "feeder")
    table = defaultdict(lambda: [0, 0, 0])
    for s in spans:
        row = table[(s.thread, s.name)]
        row[0] += 1
        row[1] += min(s.end_ns, w1) - max(s.start_ns, w0)
        row[2] += sum(b - a for a, b in own[s.id])
    for thread in sorted({t for t, _ in table}, key=lambda t: roles.get(t, "~")):
        rows = sorted(((n, *v) for (t, n), v in table.items() if t == thread),
                      key=lambda r: -r[2])
        print(f"thread {roles.get(thread, thread)}:")
        print(f"  {'span':<26} {'n':>6} {'total s':>9} {'self s':>9}")
        for name, n, tot, self_ in rows:
            kind = "wait" if name.endswith("wait") else "busy"
            print(f"  {name:<26} {n:>6} {tot / 1e9:>9.4f} {self_ / 1e9:>9.4f} {kind}")
    sys.stdout.flush()


if __name__ == "__main__":
    sys.exit(main())
