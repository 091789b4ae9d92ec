"""A re-timing job made from a seed: two WAVs, a script and two clips.

``chip_smoke.py`` re-times this job on the card, and
``tools/make_torch_smoke_fixture.py --sync`` runs the JAX package on it for
the references in ``vse_tpu_torch/assets/smoke/reference_sync.json``.
Nothing here is committed but the code: the audio is made anew in each run.

- ``write_wav_pair``: 24 minutes at 12 kHz, 16-bit mono (34.6 MB each). The
  source is noise in bursts of random length and loudness; the destination
  is the source with ``INSERT_SECONDS`` of other noise inserted at
  ``INSERT_AT`` (11 minutes), so a script has two shift groups, 0 and
  +3.2 s, and a little noise of its own. Integer arithmetic only, from numpy's PCG64 stream, so every
  machine writes the same bytes (``sha256`` checks it).
- ``script_cues``: ~300 cues of 2-4 s with gaps of 0.4-3 s, none within a
  second of the insert.
- ``scene_clip``: two 20 s 1280x720 25 fps clips of panning blocky scenes
  with cuts; the destination has 80 frames (3.2 s) of another scene
  inserted at 11 s (the audio's insert, at the clip's scale).
"""

from __future__ import annotations

import hashlib
import os
import wave
from typing import List, Optional, Tuple

import numpy as np

from vse_tpu_torch.sync.common import format_srt_time
from vse_tpu_torch.video.decode import InMemoryVideo

RATE = 12000
SECONDS = 24 * 60
INSERT_AT = 11 * 60  # seconds into the source
INSERT_SECONDS = 3.2
FPS = 25.0
CLIP_FRAMES = 500  # 20 s
CLIP_INSERT_AT = 275  # frame (11 s)
CLIP_INSERT = 80  # frames (3.2 s)
# the source clip's scene cuts (0-based first frames of each scene)
CLIP_CUTS = (0, 62, 131, 213, 290, 352, 440)


def _noise_bursts(rng: np.random.Generator, n: int) -> np.ndarray:
    """int16 [n]: uniform noise in bursts of 50-500 ms, each at its own
    loudness."""
    out = np.empty(n, np.int16)
    pos = 0
    while pos < n:
        length = int(rng.integers(RATE // 20, RATE // 2))
        amp = int(rng.integers(600, 12000))
        seg = rng.integers(-1024, 1024, size=min(length, n - pos), dtype=np.int32)
        out[pos : pos + len(seg)] = (seg * amp) >> 10
        pos += len(seg)
    return out


def audio_pair(seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(source, destination) int16 samples. The destination carries its own
    small noise (+-200), as another encode of the same cut would: the
    re-timer divides by the match scores, which an exact copy makes 0."""
    rng = np.random.default_rng(seed)
    src = _noise_bursts(rng, SECONDS * RATE)
    cut = INSERT_AT * RATE
    insert = _noise_bursts(rng, int(round(INSERT_SECONDS * RATE)))
    dst = np.concatenate([src[:cut], insert, src[cut:]]).astype(np.int32)
    dst += rng.integers(-200, 201, size=len(dst), dtype=np.int32)
    return src, np.clip(dst, -32768, 32767).astype(np.int16)


def write_wav(path: str, samples: np.ndarray) -> str:
    """Write 16-bit mono PCM; returns the file's sha256."""
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(RATE)
        w.writeframes(samples.astype("<i2").tobytes())
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def write_wav_pair(directory: str, seed: int) -> Tuple[str, str, dict]:
    """(source path, destination path, {name: sha256}) in ``directory``."""
    src, dst = audio_pair(seed)
    paths = {name: os.path.join(directory, f"{name}.wav") for name in ("src", "dst")}
    sums = {"src": write_wav(paths["src"], src), "dst": write_wav(paths["dst"], dst)}
    return paths["src"], paths["dst"], sums


def script_cues(seed: int) -> List[Tuple[int, int, str]]:
    """[(start ms, end ms, text)] over the source's 24 minutes."""
    rng = np.random.default_rng(seed + 1)
    cues = []
    t = 1000
    keep_out = ((INSERT_AT - 1) * 1000, (INSERT_AT + 1) * 1000)
    while True:
        dur = int(rng.integers(2000, 4001))
        if t < keep_out[1] and t + dur > keep_out[0]:
            t = keep_out[1]
        if t + dur > (SECONDS - 2) * 1000:
            break
        cues.append((t, t + dur, f"line {len(cues) + 1}"))
        t += dur + int(rng.integers(400, 3001))
    return cues


def write_srt(path: str, cues: List[Tuple[int, int, str]]) -> None:
    blocks = [f"{i + 1}\n{format_srt_time(a / 1000)} --> {format_srt_time(b / 1000)}\n{text}"
              for i, (a, b, text) in enumerate(cues)]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n\n".join(blocks) + "\n")


def _scene(rng: np.random.Generator, width: int) -> np.ndarray:
    """u8 [720, width, 3]: 16 x 16 px blocks of random colours."""
    small = rng.integers(0, 256, size=(45, -(-width // 16), 3), dtype=np.uint8)
    return np.repeat(np.repeat(small, 16, axis=0), 16, axis=1)[:, :width]


def scene_clip(seed: int, name: str, out: Optional[np.ndarray] = None,
               path: str = "sync") -> InMemoryVideo:
    """The ``name`` ("src" or "dst") 20 s 720p clip (1.4 GB), written into
    ``out`` when it is given. Each scene pans one pixel a frame; the
    destination is the source's frames up to ``CLIP_INSERT_AT``, the
    inserted scene, then the source's next frames."""
    rng = np.random.default_rng(seed + 2)
    bounds = list(CLIP_CUTS) + [CLIP_FRAMES]
    scenes = [_scene(rng, 1280 + b - a) for a, b in zip(bounds, bounds[1:])]
    insert = _scene(rng, 1280 + CLIP_INSERT)
    frames = [(img, k) for img, a, b in zip(scenes, bounds, bounds[1:]) for k in range(b - a)]
    if name == "dst":
        frames = (frames[:CLIP_INSERT_AT] + [(insert, k) for k in range(CLIP_INSERT)]
                  + frames[CLIP_INSERT_AT:])[:CLIP_FRAMES]
    elif name != "src":
        raise ValueError(f"scene_clip makes 'src' or 'dst', not {name!r}")
    if out is None:
        out = np.empty((CLIP_FRAMES, 720, 1280, 3), np.uint8)
    for i, (img, k) in enumerate(frames):
        out[i] = img[:, k : k + 1280]
    return InMemoryVideo(out, FPS, f"{path}_{name}.avi")
