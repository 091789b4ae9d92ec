#!/usr/bin/env python3
"""Time K1 and K2 of one ``vse_tpu_torch`` tree on one CUDA card, through
the calls both the current and the earlier kernel modules expose.

    python3 tools/time_kernels.py [--tree DIR] [--label NAME] [--sweep]

``--tree`` is the directory holding the ``vse_tpu_torch`` package to time
(default: this checkout). To compare two commits on one card, unpack the
older one into a git-ignored directory here, e.g.

    mkdir -p _smoke_tree/old && git archive <commit> vse_tpu_torch | tar -x -C _smoke_tree/old

and run the script on both trees in turns (old, new, new, old) on one card,
one after the other: each run builds its tree's kernels and prints one JSON
line.

At the main path's shapes (K2: the smoke fixture's [32, 104, 1280, 3]
band; K1: [64, 80, 69] (en), [64, 80, 21060] (ch) and [64, 80, 21249]
(japan) random logits):

- ``device_us``: 100 calls of ``frame_stats_cuda(band)`` or
  ``ctc_greedy_decode(x)`` captured in a CUDA graph and replayed between
  CUDA events, over 100: the device time of the whole call (every kernel it
  issues, PyTorch's included), with no host work in the window;
- ``wall_us``: the host clock around 200 such calls and a synchronize, over
  200;
- ``argmax_lse_device_us``: for a tree whose K1 module has the two-step API
  (``argmax_lse_cuda``, then ``collapse`` in PyTorch), that kernel alone.

``--sweep`` also times K2's launch geometries (threads a block, frames a
block walks) by device time, and K2 on random pixels at the band's shape
(a warp's table lookups spread over the shared-memory banks), on trees that have
``launch_geometry``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """chip_smoke.py's timers (``device_us``: a CUDA-graph replay of 100
    calls; ``wall_us``: host clock over 200 calls and a synchronize), loaded
    by path so that ``--tree`` alone decides which package is imported."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("time_kernels.py: CUDA is not available", file=sys.stderr)
        return 2
    from vse_tpu_torch.kernels import ctc_decode as k1
    from vse_tpu_torch.kernels import keyframe as k2
    from vse_tpu_torch.video.synth import compose_frames, load_fixture

    smoke = _smoke()
    device_us, wall_us = smoke.device_us, smoke.wall_us

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    res = {"tree": os.path.relpath(tree, ROOT), "label": args.label, "card": smi}

    bands, recipe = load_fixture()
    y0, y1, x0, x1 = recipe["area"]
    clip = compose_frames(bands, recipe, n_frames=64)
    band = torch.from_numpy(clip[32:64, y0:y1, x0:x1].copy()).cuda()
    res["K2"] = {
        "shape": list(band.shape),
        "device_us": device_us(lambda: k2.frame_stats_cuda(band)),
        "wall_us": wall_us(lambda: k2.scan_stats_u8(band)),
    }
    if args.sweep and hasattr(k2, "launch_geometry"):
        T, H, W, _ = band.shape
        p = k2.ScanParams()
        sweep = {}
        for threads in (64, 128, 256):
            for run in (1, 2, 4, 8):
                g = k2.launch_geometry(T, H, W, p, threads, run)
                partials, out = k2.alloc_outputs(T, g, band.device)
                key = f"{threads}x{run} ({g.n_parts * g.n_runs} blocks)"
                sweep[key] = device_us(lambda: k2.launch(band, g, p, partials, out))
        res["K2"]["sweep_device_us"] = sweep
        g = torch.Generator().manual_seed(7)
        noise = torch.randint(0, 256, tuple(band.shape), generator=g, dtype=torch.uint8).cuda()
        res["K2"]["random_band_device_us"] = device_us(lambda: k2.frame_stats_cuda(noise))

    for N, T, C in ((64, 80, 69), (64, 80, 21060), (64, 80, 21249)):
        g = torch.Generator().manual_seed(C)
        x = (torch.randn((N, T, C), generator=g) * 4.0).cuda()
        row = {
            "device_us": device_us(lambda: k1.ctc_greedy_decode(x)),
            "wall_us": wall_us(lambda: k1.ctc_greedy_decode(x)),
        }
        if hasattr(k1, "argmax_lse_cuda"):
            row["argmax_lse_device_us"] = device_us(lambda: k1.argmax_lse_cuda(x))
        res[f"K1 [{N},{T},{C}]"] = row
        del x
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
