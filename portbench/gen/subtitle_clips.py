"""Generator of kind ``subtitle_clips``: a pool of subtitled video files
drawn from a seed, as a traffic file's parameters describe it.

A clip is ``clip_seconds`` of ``width`` x ``height`` video at ``fps``.
Above and below the subtitle bar a smooth colour gradient drifts slowly
(its phases and colours drawn per clip), so decoding does real work and no
false text appears; the bar (``bar_rows``) is one flat colour, as in a
letterboxed film. ``cues`` lists every clip's cues as (duration s, gap
before it s, glyphs); a clip holds them all in an order drawn from the
seed, each line of that many glyph cells of ``glyphs`` (cut from rendered
subtitle bands) drawn from the seed and centred on ``center_x``. So every
seed offers the same work in another order. No line repeats within a pool
or in the warm-up clip. ``extras`` paste fixed bands (a corner watermark for the
whole clip, a scene-text line for a stretch of it) from ``.npz`` files.

Clips are encoded with OpenCV's ``VideoWriter`` (``fourcc``) in parallel
worker processes, into a cache directory keyed by the traffic file's hash
and the seed; a pool that is already there is read back as it is.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import shutil
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
KEEP_POOLS = 8  # pool directories kept per traffic mix (the newest)


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


def _load_glyphs(spec: dict) -> dict:
    with np.load(os.path.join(ROOT, spec["file"])) as z:
        return {k: np.asarray(z[k]) for k in z.files}


def plan_pool(traffic: dict, seed: int) -> List[dict]:
    """The pool's clips (index 0 is the warm-up clip): each a dict of its
    gradient parameters and cues ``{first, last, cells, text}`` (1-based
    inclusive frame numbers), every line distinct."""
    glyphs = _load_glyphs(traffic["glyphs"])
    chars = [str(c) for c in glyphs["chars"]]
    fps, n_frames = traffic["fps"], int(round(traffic["clip_seconds"] * traffic["fps"]))
    seen = set()
    clips = []
    for ci in range(traffic["pool"] + 1):
        rng = _rng(seed, ci)
        cues = []
        t = 0.0
        # every clip holds the same cues (duration, gap before, glyphs), in
        # an order of its own, so that seeds change the text and not the work
        for j in rng.permutation(len(traffic["cues"])):
            dur, gap, n_cells = traffic["cues"][int(j)]
            t += gap
            first, last = int(round(t * fps)) + 1, int(round((t + dur) * fps))
            if last > n_frames:
                raise ValueError("the mix's cues do not fit in a clip")
            while True:
                cells = [int(i) for i in rng.integers(0, len(chars), n_cells)]
                text = "".join(chars[i] for i in cells)
                if text not in seen:
                    seen.add(text)
                    break
            cues.append({"first": first, "last": last, "cells": cells, "text": text})
            t += dur
        extras = []
        for ex in traffic.get("extras", []):
            if ex.get("seconds"):
                dur = float(rng.uniform(*ex["seconds"]))
                start = float(rng.uniform(0.0, traffic["clip_seconds"] - dur))
                first, last = int(round(start * fps)) + 1, int(round((start + dur) * fps))
            else:
                first, last = 1, n_frames
            extras.append({"band": ex["band"], "file": ex["file"], "origin": ex["origin"],
                           "first": first, "last": last, "text": ex.get("text", "")})
        clips.append({
            "index": ci, "n_frames": n_frames, "cues": cues, "extras": extras,
            "gradient": {
                "base": rng.uniform(70, 150, 3).tolist(),
                "amp": rng.uniform(20, 45, 2).tolist(),
                "k": rng.uniform(0.002, 0.006, 2).tolist(),
                "pan": float(rng.uniform(0.3, 0.8)),
                "phase": rng.uniform(0, 2 * np.pi, 6).tolist(),
            },
        })
    return clips


def render_frames(traffic: dict, clip: dict, glyphs: dict,
                  extra_bands: Dict[str, np.ndarray]) -> np.ndarray:
    """The clip's uint8 RGB frames [N, H, W, 3]."""
    H, W, N = traffic["height"], traffic["width"], clip["n_frames"]
    g = clip["gradient"]
    # one gradient image wider than a frame, panned by ``pan`` px a frame
    offs = np.round(np.arange(N) * g["pan"]).astype(np.int64)
    y = np.arange(H, dtype=np.float32)[:, None]
    x = np.arange(W + int(offs[-1]) + 1, dtype=np.float32)[:, None]
    ph = np.asarray(g["phase"], np.float32)
    rows = g["amp"][0] * np.sin(g["k"][0] * y + ph[None, :3])
    cols = g["amp"][1] * np.cos(g["k"][1] * x + ph[None, 3:])
    big = np.clip(np.asarray(g["base"], np.float32) + rows[:, None] + cols[None, :], 0, 255)
    big = big.astype(np.uint8)
    frames = np.empty((N, H, W, 3), np.uint8)
    for t in range(N):
        frames[t] = big[:, offs[t] : offs[t] + W]
    y0, y1 = traffic["bar_rows"]
    frames[:, y0:y1] = np.asarray(traffic["bar_color"], np.uint8)
    cells, widths = glyphs["cells"], glyphs["widths"]
    for cue in clip["cues"]:
        line_w = int(sum(widths[i] for i in cue["cells"]))
        x0 = traffic["center_x"] - line_w // 2
        strip = np.concatenate([cells[i, :, : widths[i]] for i in cue["cells"]], axis=1)
        frames[cue["first"] - 1 : cue["last"], y0 : y0 + strip.shape[0], x0 : x0 + line_w] = strip
    for ex in clip["extras"]:
        band = extra_bands[ex["band"]]
        oy, ox = ex["origin"]
        frames[ex["first"] - 1 : ex["last"], oy : oy + band.shape[0],
               ox : ox + band.shape[1]] = band
    return frames


def _encode(job) -> str:
    traffic, clip, path = job
    import cv2

    cv2.setNumThreads(1)
    glyphs = _load_glyphs(traffic["glyphs"])
    extra_bands = {}
    for ex in clip["extras"]:
        with np.load(os.path.join(ROOT, ex["file"])) as z:
            extra_bands[ex["band"]] = np.asarray(z[ex["band"]])
    frames = render_frames(traffic, clip, glyphs, extra_bands)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*traffic["fourcc"]),
                             float(traffic["fps"]), (traffic["width"], traffic["height"]))
    if not writer.isOpened():
        raise RuntimeError(f"OpenCV cannot write {traffic['fourcc']} video to {path}")
    for f in frames:
        writer.write(np.ascontiguousarray(f[:, :, ::-1]))
    writer.release()
    return path


def traffic_key(traffic: dict) -> str:
    return hashlib.sha256(json.dumps(traffic, sort_keys=True).encode()).hexdigest()[:12]


def make_pool(traffic: dict, traffic_path: str, seed: int, cache_root: str,
              workers: int) -> dict:
    """The pool for ``seed``: ``{"dir", "clips": [...], "warmup": clip,
    "encoded": bool, "seconds"}``; each clip also has its file ``path``.
    Encodes into ``cache_root`` unless the pool is already there."""
    t0 = time.perf_counter()
    name = os.path.splitext(os.path.basename(traffic_path))[0]
    key = f"{name}-{traffic_key(traffic)}-{seed}"
    out = os.path.join(cache_root, key)
    manifest = os.path.join(out, "manifest.json")
    encoded = False
    if not os.path.exists(manifest):
        clips = plan_pool(traffic, seed)
        tmp = out + ".partial"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        jobs = [(traffic, c, os.path.join(tmp, f"clip_{c['index']:03d}.mp4")) for c in clips]
        with ProcessPoolExecutor(max_workers=max(1, workers),
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            list(ex.map(_encode, jobs))
        with open(os.path.join(tmp, "manifest.json"), "w", encoding="utf-8") as f:
            json.dump(clips, f)
        shutil.rmtree(out, ignore_errors=True)
        os.replace(tmp, out)
        encoded = True
        _evict(cache_root, name)
    else:
        os.utime(out)
    with open(manifest, "r", encoding="utf-8") as f:
        clips = json.load(f)
    for c in clips:
        c["path"] = os.path.join(out, f"clip_{c['index']:03d}.mp4")
    return {"dir": out, "warmup": clips[0], "clips": clips[1:], "encoded": encoded,
            "seconds": time.perf_counter() - t0}


def _evict(cache_root: str, name: str) -> None:
    pools = sorted((d for d in os.listdir(cache_root)
                    if d.startswith(name + "-") and not d.endswith(".partial")),
                   key=lambda d: os.path.getmtime(os.path.join(cache_root, d)))
    for d in pools[:-KEEP_POOLS]:
        shutil.rmtree(os.path.join(cache_root, d), ignore_errors=True)
