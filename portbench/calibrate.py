#!/usr/bin/env python3
"""Readings from which a cell's limits are set: the comparison's numbers for
the program on many seeds (the lower readings), for the control, the
reference computed in the precision below the configuration's, put in the
program's place, and for faults planted in the program's output (the upper
readings), all at the cell's own sizes, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --fault-seeds 1,2,3 --write-limits

Each seed's pool holds the clips a run judges (``sample_clips``), drawn as
a run draws its pool. On the fault seeds (a subset of ``--seeds``) the
program's own output of the same clips is judged once more for each fault
of ``FAULTS``, planted in it. Prints one JSON line a seed and side (its
numbers, and each clip's line corner gaps), then the largest program
reading and the smallest reading of every other side, for each number.

``--write-limits`` writes ``limits/<cell>.json`` from those readings: an
exact number (``EXACT``) whose program readings are all 0 gets the limit 0.
Another number has an upper reading: the least of the control's smallest
reading where that is three times the largest program reading (the
lower) or more, and of each fault's smallest where that is ten times the
lower or more. Its limit is ``lower ** 0.3 * upper ** 0.7`` (in log scale
70% of the way from the lower reading to the upper, the more room above
the lower), or ``0.7 * upper`` where the lower is 0; no limit without an
upper reading. The file keeps every seed's reading of every side.

``--from-log a,b,...`` adds the per-seed lines of earlier calls' output
(and of ``run.py`` runs, in the same form) to what is measured, or takes
them alone, so that the limits can be written again from all readings.
"""

from __future__ import annotations

import argparse
import copy
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import numpy as np  # noqa: E402
import run as R  # noqa: E402

import judge  # noqa: E402
from reference import clip as C  # noqa: E402

EXACT = ("span_mismatch", "srt_mismatch", "frames_unread")
RULE = ("exact numbers 0; others lower ** 0.3 * upper ** 0.7 (0.7 * upper where the lower is "
        "0), the upper reading the least of the control's smallest where it reads at least 3x "
        "the program's largest (the lower) and each planted fault's smallest where it reads at "
        "least 10x")


def _planted(cap: "R.Capture", change) -> "R.Capture":
    """The capture with ``change`` applied to each OCR chunk's arrays."""
    out = copy.copy(cap)
    out.chunks = [change(*[a.copy() for a in chunk]) for chunk in cap.chunks]
    return out


def det_half_empty(cap: "R.Capture") -> "R.Capture":
    """As if the det had found boxes in the first half of each OCR chunk
    only."""
    def change(boxes, det_scores, valid, ids, mask, rec_scores):
        keep = len(valid) // 2
        valid[keep:], mask[keep:] = False, False
        return boxes, det_scores, valid, ids, mask, rec_scores
    return _planted(cap, change)


def altered_read(cap: "R.Capture") -> "R.Capture":
    """As if every character read had come out as class 1 (class 2 where
    it was 1) where the OCR step produces it."""
    def change(boxes, det_scores, valid, ids, mask, rec_scores):
        return boxes, det_scores, valid, np.where(mask, np.where(ids == 1, 2, 1), ids), mask, \
            rec_scores
    return _planted(cap, change)


FAULTS = {"det_half_empty": det_half_empty, "altered_read": altered_read}
SIDES = ("program", "control") + tuple(FAULTS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--traffic-file", default="")
    ap.add_argument("--cache", default=os.path.join(HERE, ".cache", "calibrate"))
    ap.add_argument("--write-limits", action="store_true")
    ap.add_argument("--from-log", default="")
    args = ap.parse_args(argv)
    bench, cell, config, traffic, tpath = R.load_cell(args.workload, args.traffic_file)
    lines, measured = measure(args, config, traffic, tpath) if args.seeds or args.control_seeds \
        else ([], None)
    for path in filter(None, args.from_log.split(",")):
        with open(path, "r", encoding="utf-8") as f:
            text = f.read().splitlines()
        lines += [json.loads(x) for x in text if x.startswith('{"side"')]
        measured = measured or next((json.loads(x[len("measured: "):]) for x in text
                                     if x.startswith("measured: ")), None)
    lines = [x for x in lines if x["side"] in SIDES]
    readings = {k: {side: [] for side in SIDES} for k in judge.NAMES}
    for line in lines:
        for k, v in line["numbers"].items():
            if k in readings:
                readings[k][line["side"]].append(v)
    readings = {k: r for k, r in readings.items() if r["program"]}
    print(json.dumps({"workload": cell["name"], **{
        side: {k: (max if side == "program" else min)(r[side])
               for k, r in readings.items() if r[side]} for side in SIDES}}))
    if args.write_limits:
        seeds = {side: [x["seed"] for x in lines if x["side"] == side] for side in SIDES}
        write_limits(cell["name"], readings, seeds, measured)
    return 0


def measure(args, config: dict, traffic: dict, tpath: str):
    """The per-seed lines of every side, printed as they come, and the
    device they were measured on."""
    small = dict(traffic, pool=traffic["sample_clips"])
    gen = importlib.import_module("gen." + traffic["kind"])
    workers = min(8, os.cpu_count() or 1)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    fseeds = {int(s) for s in args.fault_seeds.split(",") if s}
    measured = None
    if args.device == "cuda":
        info = R.card_info(args.device)
        measured = {"kind": info["kind"], "power_limit_w": info.get("power_limit_w")}
    print("measured: " + json.dumps(measured), flush=True)
    prog = R.Program(config, traffic, args.device) if seeds else None
    ref = C.Reference(config, args.device)
    ctl = C.Reference(config, args.device, control=True) if cseeds else None
    lines = []
    for side, seed_list in (("program", seeds), ("control", cseeds)):
        for seed in seed_list:
            t0 = time.perf_counter()
            pool = gen.make_pool(small, tpath, seed, args.cache, workers)
            if side == "program" and not prog.graphs():
                prog.warm_shapes()
                prog.run(pool["warmup"])
            judged = {}
            for clip in pool["clips"]:
                frames, ts, fps = C.decode(clip["path"])
                if side == "program":
                    cap = prog.run(clip)
                    todo = [("program", cap)] + [(name, plant(cap)) for name, plant in FAULTS.items()
                                                 if seed in fseeds]
                    todo = [(s, c.produced(traffic["strategy"])) for s, c in todo]
                else:
                    todo = [(side, judge.control_produced(ctl, traffic, clip["path"], frames, ts,
                                                          fps))]
                for s, produced in todo:
                    per, detail = judged.setdefault(s, ([], {}))
                    per.append(judge.judge_clip(produced, ref, traffic, frames, ts, fps, seed,
                                                detail))
            for s, (per, detail) in judged.items():
                line = {"side": s, "seed": seed, "numbers": judge.worst(per),
                        "line_gaps": [[None if g is None else round(g, 3) for g in c]
                                      for c in detail.get("line_gaps", [])],
                        "seconds": round(time.perf_counter() - t0, 3)}
                print(json.dumps(line), flush=True)
                lines.append(line)
    return lines, measured


def limit_of(name: str, r: dict):
    """The limit of a number from its readings (see the module's doc)."""
    lower = max(r["program"])
    if name in EXACT:
        return 0.0 if lower == 0 else None
    ups = [min(r[side]) for side, times in [("control", 3)] + [(f, 10) for f in FAULTS]
           if r[side] and min(r[side]) >= times * lower and min(r[side]) > 0]
    if not ups:
        return None
    return float(lower ** 0.3 * min(ups) ** 0.7 if lower > 0 else 0.7 * min(ups))


def write_limits(cell: str, readings: dict, seeds: dict, measured) -> None:
    limits = {}
    for k, r in readings.items():
        r["limit"] = limit_of(k, r)
        if r["limit"] is not None:
            limits[k] = r["limit"]
    path = os.path.join(HERE, "limits", cell + ".json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"limits": limits, "readings": readings, "seeds": seeds,
                   "measured": measured, "rule": RULE}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    sys.exit(main())
