"""Compose a subtitled clip in memory from pre-rendered text bands.

A fixture directory holds ``bands.npz`` (uint8 RGB bands, rendered on the
clip's background colour) and ``recipe.json``::

    {"width": W, "height": H, "fps": F, "n_frames": N,
     "background": [r, g, b], "band_origin": [y, x],
     "area": [ymin, ymax, xmin, xmax],
     "cues": [{"band": "band0", "text": "...", "first": 26, "last": 150}, ...]}

Cue frame numbers are 1-based and inclusive. ``compose_clip`` pastes each
cue's band at ``band_origin`` on a plain background, so the clip needs no
font, codec or OpenCV at run time. ``vse_tpu_torch/assets/smoke/`` is the
fixture that ``chip_smoke.py`` drives (made by
``tools/make_torch_smoke_fixture.py``).
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


def load_fixture(path: str = SMOKE_FIXTURE) -> Tuple[Dict[str, np.ndarray], dict]:
    with np.load(os.path.join(path, "bands.npz")) as z:
        bands = {k: np.asarray(z[k]) for k in z.files}
    with open(os.path.join(path, "recipe.json"), "r", encoding="utf-8") as f:
        recipe = json.load(f)
    return bands, recipe


def compose_frames(bands: Dict[str, np.ndarray], recipe: dict,
                   n_frames: Optional[int] = None) -> np.ndarray:
    """uint8 RGB frames [N, H, W, 3] of the recipe (its first ``n_frames``
    when given)."""
    n = recipe["n_frames"] if n_frames is None else n_frames
    frames = np.empty((n, recipe["height"], recipe["width"], 3), np.uint8)
    frames[:] = np.asarray(recipe["background"], np.uint8)
    y, x = recipe["band_origin"]
    for cue in recipe["cues"]:
        band = bands[cue["band"]]
        h, w, _ = band.shape
        frames[cue["first"] - 1 : min(cue["last"], n), y : y + h, x : x + w] = band
    return frames


def compose_clip(bands: Dict[str, np.ndarray], recipe: dict, path: str,
                 n_frames: Optional[int] = None) -> InMemoryVideo:
    """The recipe's clip as an ``InMemoryVideo`` whose outputs go next to
    ``path``."""
    return InMemoryVideo(compose_frames(bands, recipe, n_frames), float(recipe["fps"]), path)


def recipe_area(recipe: dict) -> SubtitleArea:
    return SubtitleArea(*recipe["area"])
