"""Compose a subtitled clip in memory from pre-rendered text bands.

A fixture directory holds band files (``bands.npz``: uint8 RGB bands,
rendered on the clip's background colour) and recipes such as
``recipe.json``::

    {"width": W, "height": H, "fps": F, "n_frames": N,
     "background": [r, g, b], "band_origin": [y, x],
     "area": [ymin, ymax, xmin, xmax],            (optional)
     "band_files": ["bands.npz", ...],            (optional, default bands.npz)
     "cues": [{"band": "band0", "text": "...", "first": 26, "last": 150,
               "origin": [y, x]}, ...]}           (origin optional)

Cue frame numbers are 1-based and inclusive. ``compose_clip`` pastes each
cue's band at its ``origin``, else at ``band_origin``, on a plain
background, so the clip needs no font, codec or OpenCV at run time.
``vse_tpu_torch/assets/smoke/`` holds the fixtures that ``chip_smoke.py``
drives (made by ``tools/make_torch_smoke_fixture.py``): ``recipe.json``,
three cues in a subtitle area, ``recipe_fps.json``, the same cues with a
corner watermark and a short scene-text line and no area, the ch clips
``recipe_ch.json`` and ``recipe_ch_fps_short.json``, and one keyframe clip
for each of the ten non-CJK families in ``recipe_scripts.json`` (``{family:
recipe}``, each with its ``language`` code; ``load_script_fixture``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from vse_tpu_torch.core.subtitle_area import SubtitleArea
from vse_tpu_torch.video.decode import InMemoryVideo

SMOKE_FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "smoke"
)


def load_fixture(path: str = SMOKE_FIXTURE, recipe: str = "recipe.json"
                 ) -> Tuple[Dict[str, np.ndarray], dict]:
    """(bands by name, recipe) of the fixture directory ``path``."""
    with open(os.path.join(path, recipe), "r", encoding="utf-8") as f:
        rec = json.load(f)
    bands: Dict[str, np.ndarray] = {}
    for name in rec.get("band_files", ["bands.npz"]):
        with np.load(os.path.join(path, name)) as z:
            bands.update({k: np.asarray(z[k]) for k in z.files})
    return bands, rec


SCRIPT_FAMILIES = ("latin", "cyrillic", "devanagari", "arabic", "korean", "el", "ta",
                   "te", "ka", "th")


def load_script_fixture(family: str, path: str = SMOKE_FIXTURE
                        ) -> Tuple[Dict[str, np.ndarray], dict]:
    """(bands, recipe) of a non-CJK family's keyframe clip: its recipe in
    ``recipe_scripts.json``, its bands the ``<family>_`` keys of the shared
    band file."""
    with open(os.path.join(path, "recipe_scripts.json"), "r", encoding="utf-8") as f:
        rec = json.load(f)[family]
    bands: Dict[str, np.ndarray] = {}
    for name in rec["band_files"]:
        with np.load(os.path.join(path, name)) as z:
            bands.update({k: np.asarray(z[k]) for k in z.files if k.startswith(f"{family}_")})
    return bands, rec


def load_script_reference(family: str, path: str = SMOKE_FIXTURE) -> dict:
    """The JAX package's reference for a family's keyframe clip
    (``reference_scripts.json``): ``language``, ``srt``, and ``lines``
    [frame_no, [xmin, xmax, ymin, ymax], text, score] of every keyframe
    sample."""
    with open(os.path.join(path, "reference_scripts.json"), "r", encoding="utf-8") as f:
        return json.load(f)[family]


def compose_frames(bands: Dict[str, np.ndarray], recipe: dict,
                   n_frames: Optional[int] = None,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
    """uint8 RGB frames [N, H, W, 3] of the recipe (its first ``n_frames``
    when given), written into ``out`` when it is given (a buffer of that
    shape, reused across clips to spare a new 1.4 GB allocation each)."""
    n = recipe["n_frames"] if n_frames is None else n_frames
    shape = (n, recipe["height"], recipe["width"], 3)
    frames = np.empty(shape, np.uint8) if out is None else out
    if frames.shape != shape:
        raise ValueError(f"out has shape {frames.shape}, the recipe's frames {shape}")
    background = np.empty(shape[1:], np.uint8)
    background[:] = np.asarray(recipe["background"], np.uint8)
    frames[:] = background  # whole-frame copies: faster than a 3-byte broadcast
    for cue in recipe["cues"]:
        band = bands[cue["band"]]
        y, x = cue.get("origin", recipe["band_origin"])
        h, w, _ = band.shape
        frames[cue["first"] - 1 : min(cue["last"], n), y : y + h, x : x + w] = band
    return frames


def compose_clip(bands: Dict[str, np.ndarray], recipe: dict, path: str,
                 n_frames: Optional[int] = None,
                 out: Optional[np.ndarray] = None) -> InMemoryVideo:
    """The recipe's clip as an ``InMemoryVideo`` whose outputs go next to
    ``path`` (its frames written into ``out`` when it is given)."""
    return InMemoryVideo(compose_frames(bands, recipe, n_frames, out), float(recipe["fps"]),
                         path)


def recipe_area(recipe: dict) -> Optional[SubtitleArea]:
    """The recipe's subtitle area, or None when it has none."""
    return SubtitleArea(*recipe["area"]) if "area" in recipe else None


def noisy_band() -> np.ndarray:
    """u8 [600, 40, 480, 3]: noise in [20, 70) from seed 0, with 30 white
    3 x 12 blocks a frame during 5 spans of 60 frames. Some of its 4 x 8
    cells sit at the scan's text-cell threshold, where a one-ulp change in
    gray flips the vote (frame 191 when it is scanned in batches of 32);
    ``noisy_band.npz`` holds the JAX package's stats of it."""
    rng = np.random.default_rng(0)
    f = rng.integers(20, 70, (600, 40, 480, 3), dtype=np.uint8)
    for s in range(5):
        for t in range(s * 120 + 30, s * 120 + 90):
            ys = rng.integers(0, 37, 30)
            xs = rng.integers(0, 468, 30)
            for y, x in zip(ys, xs):
                f[t, y : y + 3, x : x + 12] = 255
    return f
