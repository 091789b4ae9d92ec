#!/usr/bin/env python
"""JSON-driven regression harness for the port's re-timer
(``vse_tpu_torch/sync``), the counterpart of ``tools/sync_regression.py``:
the same config format, the same output lines and the same
``expected_errors`` semantics, with the port's runner on ``--device``
(``cuda`` by default, as the port's CLIs; ``cpu`` on a machine without one).

    python tools/sync_regression_torch.py tests.json [--device cpu]

Mirrors the reference's sushi regression pattern (reference
backend/sushi/regression-tests.py:37-210): a JSON config lists tests; each
runs the real CLI flow, compares the shifted script against an ideal at frame
resolution, and REQUIRES the failure count to exactly equal
`expected_errors` (more OR fewer fails — golden tolerance). WAV perf tests
bound load time and memory.

Config format:
{
  "basepath": ".",
  "tests": [
    {"name": "...", "src": "a.wav", "dst": "b.wav", "script": "in.srt",
     "ideal": "ideal.srt", "fps": 23.976, "expected_errors": 0,
     "max_time": 10.0}
  ],
  "wav_tests": [
    {"name": "...", "file": "a.wav", "max_time": 5.0, "max_memory": 1.0}
  ]
}
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compare_scripts(ideal_path: str, result_path: str, fps: float) -> int:
    """Count events whose start or end lands on a different frame than the
    ideal (the reference compares at frame granularity via
    Timecodes.get_frame_number)."""
    from vse_tpu_torch.sync.events import AssScript, SrtScript
    from vse_tpu_torch.sync.timecodes import Timecodes

    tc = Timecodes.cfr(fps)
    loader = AssScript if ideal_path.endswith(".ass") else SrtScript
    ideal = loader.from_file(ideal_path).events
    result = loader.from_file(result_path).events
    if len(ideal) != len(result):
        return abs(len(ideal) - len(result)) + len(ideal)
    failures = 0
    for a, b in zip(ideal, result):
        if (
            tc.get_frame_number(a.start) != tc.get_frame_number(b.start)
            or tc.get_frame_number(a.end) != tc.get_frame_number(b.end)
        ):
            failures += 1
    return failures


def run_test(test: dict, basepath: str, device: str) -> bool:
    from vse_tpu_torch.sync.cli import create_arg_parser
    from vse_tpu_torch.sync.runner import run

    p = lambda k: os.path.join(basepath, test[k])
    out = os.path.join(basepath, test.get("output", test["name"] + ".out.srt"))
    argv = ["--src", p("src"), "--dst", p("dst"), "--script", p("script"),
            "-o", out, "--device", device] + list(test.get("extra_args", []))
    t0 = time.time()
    run(create_arg_parser().parse_args(argv))
    elapsed = time.time() - t0
    failures = compare_scripts(p("ideal"), out, test.get("fps", 23.976))
    expected = test.get("expected_errors", 0)
    ok = failures == expected
    if "max_time" in test and elapsed > test["max_time"]:
        ok = False
    status = "OK" if ok else "FAIL"
    print(f"[{status}] {test['name']}: {failures} errors "
          f"(expected {expected}), {elapsed:.1f}s")
    return ok


def run_wav_test(test: dict, basepath: str) -> bool:
    from vse_tpu_torch.sync.wav import WavStream

    t0 = time.time()
    WavStream(os.path.join(basepath, test["file"]), device="cpu")
    elapsed = time.time() - t0
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    ok = True
    if "max_time" in test and elapsed > test["max_time"]:
        ok = False
    if "max_memory" in test and rss_gb > test["max_memory"]:
        ok = False
    status = "OK" if ok else "FAIL"
    print(f"[{status}] wav {test['name']}: {elapsed:.2f}s, {rss_gb:.2f} GB")
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    with open(args.config, "r", encoding="utf-8") as f:
        cfg = json.load(f)
    basepath = cfg.get("basepath", os.path.dirname(os.path.abspath(args.config)))
    ok = True
    for test in cfg.get("tests", []):
        ok &= run_test(test, basepath, args.device)
    for test in cfg.get("wav_tests", []):
        ok &= run_wav_test(test, basepath)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
