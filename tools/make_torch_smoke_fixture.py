"""Make the fixture that ``chip_smoke.py`` drives through the PyTorch port.

Writes ``vse_tpu_torch/assets/smoke/``:

  bands.npz      three uint8 RGB text bands (1280 x 104, white text with a
                 black outline on the clip's plain background), rendered with
                 PIL and DejaVu Sans at 36 px
  recipe.json    the clip: 1280x720, 25 fps, 500 frames (20 s), three cues
                 with gaps, the band's origin and the subtitle area
  reference.srt  the JAX package's SRT for that clip: the clip is written
                 losslessly (FFV1) and run through
                 ``python -m vse_tpu.cli extract CLIP --area 600,704,0,1280
                 --mode fast --language en --no-word-segmentation`` on the CPU

Run it with JAX on the CPU (it needs PIL, OpenCV and the en rec head):

    JAX_PLATFORMS=cpu python tools/make_torch_smoke_fixture.py
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "vse_tpu_torch", "assets", "smoke")
FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
W, H, FPS, N = 1280, 720, 25, 500
BG = (30, 40, 60)
BAND_Y, BAND_H = 600, 104
# (text, first frame, last frame), 1-based and inclusive. The scanner's
# text-cell vote needs thin dense strokes: at this size and outline every
# band clears text_cell_frac (0.02) more than twice over.
CUES = [
    ("hello from the new port on the card", 26, 150),
    ("a second line of text comes here", 176, 300),
    ("and this is the last cue of the clip", 351, 450),
]


def render_band(text: str) -> np.ndarray:
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.truetype(FONT, 36)
    img = Image.new("RGB", (W, BAND_H), BG)
    d = ImageDraw.Draw(img)
    tw = d.textlength(text, font=font)
    d.text(((W - tw) // 2, 30), text, font=font, fill=(255, 255, 255),
           stroke_width=2, stroke_fill=(0, 0, 0))
    return np.asarray(img, np.uint8)


def write_lossless(frames: np.ndarray, path: str) -> None:
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), float(FPS), (W, H))
    for f in frames:
        vw.write(np.ascontiguousarray(f[:, :, ::-1]))
    vw.release()
    cap = cv2.VideoCapture(path)
    for i, f in enumerate(frames):
        ok, g = cap.read()
        if not ok or not np.array_equal(g[:, :, ::-1], f):
            raise SystemExit(f"{path}: frame {i} did not decode losslessly")
    cap.release()


def main() -> None:
    from vse_tpu_torch.video.synth import compose_frames

    os.makedirs(OUT, exist_ok=True)
    bands = {f"band{i}": render_band(t) for i, (t, _, _) in enumerate(CUES)}
    recipe = {
        "width": W, "height": H, "fps": FPS, "n_frames": N,
        "background": list(BG), "band_origin": [BAND_Y, 0],
        "area": [BAND_Y, BAND_Y + BAND_H, 0, W],
        "cues": [
            {"band": f"band{i}", "text": t, "first": a, "last": b}
            for i, (t, a, b) in enumerate(CUES)
        ],
    }
    np.savez_compressed(os.path.join(OUT, "bands.npz"), **bands)
    with open(os.path.join(OUT, "recipe.json"), "w", encoding="utf-8") as f:
        json.dump(recipe, f, indent=1)
        f.write("\n")

    from vse_tpu.cli import main as vse_main

    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "smoke.avi")
        write_lossless(compose_frames(bands, recipe), clip)
        area = ",".join(str(v) for v in recipe["area"])
        rc = vse_main(["extract", clip, "--area", area, "--mode", "fast",
                       "--language", "en", "--no-word-segmentation"])
        if rc != 0:
            raise SystemExit(f"vse_tpu.cli extract returned {rc}")
        shutil.copyfile(os.path.join(tmp, "smoke.srt"),
                        os.path.join(OUT, "reference.srt"))
    with open(os.path.join(OUT, "reference.srt"), encoding="utf-8") as f:
        print(f.read())


if __name__ == "__main__":
    main()
