#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``portbench/configs/<config>.json``) under a traffic mix
(``portbench/traffic/<traffic>.json``). The run

1. generates the mix's pool of clip files from the seed (``gen/<kind>.py``,
   cached under ``portbench/.cache/``); this is input generation, timed
   apart and not part of ``setup_s``;
2. sets up the program: the CUDA context, its kernels, one ``OcrEngine``
   in the mode the configuration gives the mix's strategy (checked to hold
   the configuration's det and rec), a warm-up clip whose lines the pool
   does not hold, and every OCR batch shape the window will use;
3. runs a closed loop of one client for ``--seconds``: each clip's
   ``SubtitleExtractor(...).run()`` with the shared engine, the next clip
   when the last SRT is written; the clip in flight at the end finishes;
4. judges a sample of the window's clips against the plain reference
   (``reference/``, ``judge.py``) with the limits of
   ``limits/<cell>.json``, after the program's memory peak is read and its
   state freed.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` wraps
the functions that ``spans/*.py`` name, profiles one whole clip after the
first, and reports the per-layer metrics that ``metrics/<name>.py`` read.
The last line of standard output is the result's JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
for _k, _v in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
               ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_k] = os.path.join(CACHE, _v)
os.environ["USE_FLAX"] = "0"
# The process's thread pools, part of every cell's deployment, fixed through
# the environment before numpy and torch load (BLAS, OpenMP, the video
# decoder's) and by their calls after (torch's intra-op pool, OpenCV's).
# README.md says why these counts.
THREADS = {"blas": 1, "torch": 2, "cv2": 2, "ffmpeg": 8}
os.environ["OPENBLAS_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(THREADS["blas"])
os.environ["OMP_NUM_THREADS"] = str(THREADS["torch"])
os.environ["OPENCV_FFMPEG_THREADS"] = str(THREADS["ffmpeg"])
sys.path[:0] = [HERE, ROOT]

import cv2  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(THREADS["torch"])
cv2.setNumThreads(THREADS["cv2"])

import devtrace  # noqa: E402
import judge  # noqa: E402
import tracer as T  # noqa: E402
from reference import arch  # noqa: E402
from reference import clip as C  # noqa: E402
from reference import post as P  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vse_tpu")


class Failure(Exception):
    """The run cannot report a result."""


def load_cell(name: str, traffic_file: str = ""):
    with open(os.path.join(ROOT, "BENCHMARK.json"), "r", encoding="utf-8") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise Failure(f"no workload {name!r} in BENCHMARK.json")
    spec = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, spec["file"]), "r", encoding="utf-8") as f:
        config = json.load(f)
    check_kinds(config)
    tpath = traffic_file or os.path.join(HERE, "traffic", cell["traffic"] + ".json")
    with open(tpath, "r", encoding="utf-8") as f:
        traffic = json.load(f)
    return bench, cell, config, traffic, tpath


def check_kinds(config: dict) -> None:
    """Each model of the configuration has its reference by its kind."""
    for part in ("det", "rec"):
        try:
            arch.of(config[part])
        except arch.UnknownKind as e:
            raise Failure(f"configuration section {part!r}: {e}") from None


def thread_counts() -> dict:
    """The thread pools as they stand: torch's intra-op pool, OpenCV's, the
    video decoder's, and each BLAS or OpenMP library's as threadpoolctl
    reads it (None where threadpoolctl is not installed)."""
    out = {"torch": torch.get_num_threads(), "cv2": cv2.getNumThreads(),
           "ffmpeg": int(os.environ["OPENCV_FFMPEG_THREADS"])}
    try:
        from threadpoolctl import threadpool_info
    except ImportError:
        out["libs"] = None
    else:
        out["libs"] = sorted({(i["internal_api"], i["num_threads"]) for i in threadpool_info()})
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_info(device) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", str(torch.device(device).index or 0)],
                             capture_output=True, text=True, timeout=20).stdout.strip()
        info["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


class Capture:
    """What the program produced for one clip, recorded around its calls:
    the scan's stats and spans, the frames it OCR'd and the arrays of each
    OCR chunk, and the SRT it wrote."""

    def __init__(self, clip: dict):
        self.clip = clip
        self.stats = None
        self.spans = None
        self.sample_frames = None
        self.batches = []  # (frame_nos, valid) of each stream batch
        self.chunks = []  # the host arrays of each OCR chunk
        self.cues = []

    def produced(self, strategy: str) -> judge.Produced:
        rows = []
        for boxes, det_scores, valid, ids, mask, rec_scores in self.chunks:
            for b in range(len(boxes)):
                reads = [[int(i) for i, m in zip(ids[b, k], mask[b, k]) if m]
                         for k in range(ids.shape[1])]
                rows.append((boxes[b], det_scores[b], valid[b], reads, rec_scores[b]))
        if strategy == "keyframe":
            frames = list(self.sample_frames)
        else:
            nos = np.concatenate([n for n, _ in self.batches]) if self.batches else np.zeros(0)
            keep = np.concatenate([v for _, v in self.batches]) if self.batches else np.zeros(0, bool)
            frames = [int(f) for f in nos[keep]]
            rows = [r for r, k in zip(rows, keep) if k]
        return judge.Produced(self.clip["path"], self.stats, self.spans, frames, rows, self.cues)


class _RecordedStream:
    """A frame stream whose batches' frame numbers are recorded."""

    def __init__(self, stream, cap: Capture):
        self._stream, self._cap = stream, cap

    def __iter__(self):
        for batch in self._stream:
            self._cap.batches.append((batch.frame_nos.copy(), batch.valid.copy()))
            yield batch

    def __getattr__(self, name):
        return getattr(self._stream, name)


class Program:
    """The system under test: one engine, and an extractor a clip."""

    def __init__(self, config: dict, traffic: dict, device: str):
        from vse_tpu_torch.core.config import VseConfig
        from vse_tpu_torch.pipeline import extractor as X
        from vse_tpu_torch.pipeline.ocr_engine import OcrEngine

        self.X = X
        self.strategy = traffic["strategy"]
        mode = config["modes"][self.strategy]
        self.vcfg = VseConfig(language=config["language"], mode=mode)
        self.device = device
        self.engine = OcrEngine(language=config["language"], mode=mode, config=self.vcfg,
                                device=device)
        held = (self.engine.spec.det_variant, self.engine.rec_variant, self.engine.family)
        want = (config["det"]["variant"], config["rec"]["variant"], config["rec"]["family"])
        if held != want:
            raise Failure(f"the engine for mode {mode} holds det/rec/family {held}, "
                          f"the configuration states {want}")
        self.area = traffic.get("area")
        self.size = (traffic["height"], traffic["width"])
        self.current = None
        self._orig_find_spans = X.find_spans
        X.find_spans = self._find_spans
        engine = self.engine

        def record_chunk(frames):
            out = type(engine).ocr_arrays(engine, frames)
            if self.current is not None:
                self.current.chunks.append(out)
            return out

        self.engine.ocr_arrays = record_chunk

    def _find_spans(self, stats, frame_nos, *a, **kw):
        spans = self._orig_find_spans(stats, frame_nos, *a, **kw)
        if self.current is not None:
            self.current.stats = np.array(stats)
            self.current.spans = [(s.start_frame, s.end_frame) for s in spans]
        return spans

    def run(self, clip: dict) -> Capture:
        from vse_tpu_torch.core.subtitle_area import SubtitleArea

        cap = self.current = Capture(clip)
        area = SubtitleArea(*self.area) if self.area else None
        ex = self.X.SubtitleExtractor(clip["path"], area, config=self.vcfg, engine=self.engine,
                                      device=self.device)
        ex.append_output = lambda *a: None  # as a service does: no console log a clip
        stream = ex.stream
        ex.stream = lambda *a, **kw: _RecordedStream(stream(*a, **kw), cap)
        targets = ex.keyframe_sample_targets

        def record_targets(spans):
            wanted, metas = targets(spans)
            cap.sample_frames = [fn for _, fn in metas]
            return wanted, metas

        ex.keyframe_sample_targets = record_targets
        try:
            ex.run()
        finally:
            self.current = None
        cap.cues = P.read_srt(ex.subtitle_output_path)
        cap.pass_seconds = dict(ex.pass_seconds)
        return cap

    def warm_shapes(self) -> None:
        """Every OCR chunk shape the window can use: the keyframe pass OCRs
        a span's last chunk of 1 to ``frame_batch`` frames. Only CUDA
        captures graphs by shape."""
        if self.strategy != "keyframe" or self.device != "cuda":
            return
        y0, y1 = C.band_rows(self.area, self.size[0], self.vcfg.subtitle_area_deviation_pixel)
        for b in range(1, self.vcfg.frame_batch + 1):
            self.engine.predict_batch(np.zeros((b, y1 - y0, self.size[1], 3), np.uint8),
                                      origin=(y0, 0))

    def graphs(self) -> int:
        rep = self.engine.replicas[0]
        return len(rep.det_forward.graphs) + len(rep.rec_forward.graphs)

    def close(self) -> None:
        self.X.find_spans = self._orig_find_spans
        self.engine = None


def cpu_seconds() -> float:
    s, c = resource.getrusage(resource.RUSAGE_SELF), resource.getrusage(resource.RUSAGE_CHILDREN)
    return s.ru_utime + s.ru_stime + c.ru_utime + c.ru_stime


def per_layer(bench: dict, cell: dict, rec: dict) -> dict:
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        mod = T.load_file(os.path.join(HERE, "metrics", m["name"] + ".py"), "metric")
        v = mod.read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge_sample(caps: list, config: dict, traffic: dict, seed: int, device: str,
                 limits: dict) -> tuple:
    """(correct, checks) of a sample of the window's clips drawn from the
    seed."""
    rng = np.random.default_rng([seed % (1 << 63), 7])
    first = {}
    for cap in caps:
        first.setdefault(cap.clip["index"], cap)
    pool = sorted(first)
    pick = [pool[i] for i in sorted(rng.choice(len(pool), min(traffic["sample_clips"], len(pool)),
                                               replace=False))]
    ref = C.Reference(config, device)
    per_clip = []
    for idx in pick:
        cap = first[idx]
        frames, ts, fps = C.decode(cap.clip["path"])
        per_clip.append(judge.judge_clip(cap.produced(traffic["strategy"]), ref, traffic,
                                         frames, ts, fps, seed))
        del frames
    numbers = judge.worst(per_clip)
    for k, v in numbers.items():
        if k not in limits:
            print(f"reading {k}: {v!r} (not compared)", file=sys.stderr)
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    correct = bool(pick) and bool(checks) and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return correct, checks, pick


def run(args) -> dict:
    bench, cell, config, traffic, tpath = load_cell(args.workload, args.traffic_file)
    device = args.device
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Failure(f"the cell needs {cell['chips']} CUDA device(s); "
                          f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    lim_path = os.path.join(HERE, "limits", cell["name"] + ".json")
    limits = {}
    if os.path.exists(lim_path):
        with open(lim_path, "r", encoding="utf-8") as f:
            limits = json.load(f)["limits"]

    gen = importlib.import_module("gen." + traffic["kind"])
    workers = args.pool_workers or min(8, os.cpu_count() or 1)
    pool = gen.make_pool(traffic, tpath, args.seed, args.cache or os.path.join(CACHE, "pool"),
                         workers)
    print(f"pool: {len(pool['clips'])} clips, {'encoded' if pool['encoded'] else 'cached'} "
          f"in {pool['seconds']:.3f} s, {pool['dir']}", file=sys.stderr)

    prog = Program(config, traffic, device)
    prog.warm_shapes()  # first, so that graphs are captured in one order whatever the seed
    prog.run(pool["warmup"])
    if args.trace and device == "cuda":  # the profiler's own start-up, outside the window
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1)
    tr = None
    if args.trace:
        tr = T.Tracer()
        tr.install()
    graphs0 = prog.graphs()
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - T_START - pool["seconds"]

    caps, clips_log, attempted, failed, prof, prof_range = [], [], 0, 0, None, None
    clips = pool["clips"]
    t_end = t0
    while time.perf_counter() - t0 < args.seconds:
        clip = clips[attempted % len(clips)]
        attempted += 1
        profiled = bool(args.trace) and attempted == 2 and device == "cuda"
        c0, u0 = time.perf_counter(), cpu_seconds()
        try:
            if profiled:
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                          torch.profiler.ProfilerActivity.CUDA])
                tr.profiling = True
                with prof:
                    with torch.profiler.record_function("portbench.clip#0"):
                        cap = prog.run(clip)
                        torch.cuda.synchronize()
                tr.profiling = False
            else:
                cap = prog.run(clip)
        except Exception as e:  # a clip that raised or wrote no SRT counts as failed
            failed += 1
            print(f"clip {clip['index']} failed: {e!r}", file=sys.stderr)
            continue
        c1 = time.perf_counter()
        t_end = c1
        if profiled:
            prof_range = (c0, c1)
        caps.append(cap)
        clips_log.append({"index": clip["index"], "s": c1 - c0, "passes": cap.pass_seconds,
                          "cpu_s": cpu_seconds() - u0, "profiled": profiled})
    wall = t_end - t0
    video_s = traffic["clip_seconds"] * len(caps)
    bad = forbidden_modules()
    if bad:
        raise Failure(f"modules loaded that the port must not load: {bad}")
    peak = torch.cuda.max_memory_reserved(device) if device == "cuda" else 0
    repeats = len(caps) - len({c.clip["index"] for c in caps})
    print(f"window: {len(caps)} clips of {attempted} started in {wall:.4f} s, {repeats} repeated "
          f"a pool clip; graphs captured in the window: {prog.graphs() - graphs0}; "
          f"per clip s: {[round(c['s'], 4) for c in clips_log]}; scan / ocr / post s: "
          f"{[tuple(round(c['passes'].get(k, 0.0), 3) for k in ('scan', 'ocr', 'post')) for c in clips_log]}",
          file=sys.stderr)

    result = {"correct": False, "attempted": attempted, "failed": failed}
    dev = card_info(device) if device == "cuda" else {"platform": "cpu", "kind": "cpu", "count": 1}
    power = dev.pop("power_limit_w", None)
    dev["memory_peak_bytes"] = int(peak)
    if args.trace:
        tr.uninstall()
        p0, p1 = prof_range or (float("inf"), float("-inf"))
        counted = [c for c in clips_log if not c["profiled"]]
        outside = lambda s: s[2] <= p0 or s[1] >= p1  # noqa: E731
        rec = {
            "config": config, "traffic": traffic,
            "video_s": traffic["clip_seconds"] * len(counted),
            "wall_s": wall - (p1 - p0 if prof_range else 0.0),
            "passes": {k: sum(c["passes"].get(k, 0.0) for c in counted)
                       for k in ("scan", "ocr", "post")},
            "cpu_s": sum(c["cpu_s"] for c in counted),
            "span_total": lambda n: sum(s[2] - s[1] for s in tr.spans if s[0] == n and outside(s)),
            "spans_shapes": lambda n: [s[4] for s in tr.spans if s[0] == n and outside(s)],
            "spans": tr.spans,
            "profile": T.profile_record(prof) if prof is not None else
            {"device": [], "launches": [], "notes": []},
        }
        result["metrics"] = per_layer(bench, cell, rec)
        bw = devtrace.busy_and_window_s(rec["profile"])
        if bw is None:
            raise Failure("the traced run profiled no clip")
        dev["busy_s"], dev["window_s"] = bw
        result["breakdown"] = devtrace.breakdown(rec["profile"])
        os.makedirs(os.path.join(CACHE, "runs"), exist_ok=True)
        with open(os.path.join(CACHE, "runs", f"{cell['name']}-{args.seed}-spans.json"), "w") as f:
            json.dump({"layers": tr.layers, "t0": t0,
                       "spans": [s[:4] + (list(s[4]), s[5]) for s in tr.spans]}, f)
        print(f"power limit: {power} W; per layer: {json.dumps(result['metrics'])}",
              file=sys.stderr)
    else:
        result["metrics"] = {
            "video_s_per_s": {"value": video_s / wall if wall > 0 else 0.0, "unit": "s/s"},
            "peak_reserved_mib": {"value": peak / 2 ** 20, "unit": "MiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    result["device"] = dev
    print(f"setup_s {setup_s:.4f} (pool {pool['seconds']:.4f} apart); "
          f"metrics {json.dumps(result['metrics'])}", file=sys.stderr)

    # the program's state is freed before the reference runs
    prog.close()
    del prog
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    correct, checks, pick = judge_sample(caps, config, traffic, args.seed, device, limits)
    print(f"judged clips {pick} in {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    result["correct"] = correct and failed == 0 and bool(caps)
    result["checks"] = checks
    for k, c in checks.items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--pool-workers", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--traffic-file", default="", help=argparse.SUPPRESS)
    ap.add_argument("--cache", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    print(f"threads: {json.dumps(thread_counts())}", file=sys.stderr)
    try:
        result = run(args)
    except Failure as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
