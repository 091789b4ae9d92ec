"""Paths and a tiny traffic mix shared by the benchmark's tests."""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
for p in (PB, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json"), "r", encoding="utf-8") as f:
        return json.load(f)


def config(name: str) -> dict:
    """The configuration file of ``BENCHMARK.json``'s config ``name``."""
    spec = next(c for c in bench()["configs"] if c["name"] == name)
    with open(os.path.join(ROOT, spec["file"]), "r", encoding="utf-8") as f:
        return json.load(f)


def tiny_traffic(tmp_path, name: str = "keyframe-area", **kw) -> str:
    """A copy of a mix with 2 s clips of one cue, written under
    ``tmp_path``."""
    with open(os.path.join(PB, "traffic", name + ".json"), "r", encoding="utf-8") as f:
        t = json.load(f)
    t.update(dict(clip_seconds=2, pool=1, sample_clips=1, cues=[[1.5, 0.3, 6]]), **kw)
    path = os.path.join(str(tmp_path), name + ".json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(t, f)
    return path
