"""Make the fixtures that ``chip_smoke.py`` drives through the PyTorch port.

Writes ``vse_tpu_torch/assets/smoke/``:

  bands.npz       three uint8 RGB text bands (1280 x 104, white text with a
                  black outline on the clip's plain background), rendered
                  with PIL and DejaVu Sans at 36 px
  recipe.json     the keyframe clip: 1280x720, 25 fps, 500 frames (20 s),
                  three cues with gaps, the band's origin and the subtitle
                  area
  bands_fps.npz   two small bands: a corner watermark ("VSE TV") and a
                  scene-text sign ("CITY CAFE")
  recipe_fps.json the no-area clip: the keyframe clip's three cues, the
                  watermark on every frame at the top right, the sign
                  mid-frame on frames 201-240, and no subtitle area
  recipe_fps_short.json  the no-area clip with each cue cut to 56 frames
                  (7 samples at stride 8), short enough that the auto
                  watermark policy keeps the subtitles
  noisy_band.npz  the JAX package's scan stats of the noisy band
                  (``vse_tpu_torch.video.synth.noisy_band``), computed by
                  ``vse_tpu.kernels.keyframe.scan_stats_u8`` in batches of 32

and the JAX package's SRTs for those clips, each clip written losslessly
(FFV1) and run through its CLI on the CPU:

  reference.srt           extract CLIP --area 600,704,0,1280 --mode fast
                          --language en --no-word-segmentation
  reference_keyframe.srt  extract CLIP --area 600,704,0,1280 --mode fast
                          --language en (word segmentation on, the default)
  reference_fps.srt       extract CLIP_FPS --language en (no area: the fps
                          strategy, the filters, word segmentation)
  reference_fps_raw.json  the raw OCR records of that run before the
                          filters, [frame_no, [xmin, xmax, ymin, ymax],
                          text, score] each (``SubtitleExtractor.
                          extract_frame_by_fps`` with the default config)
  reference_fps_short.srt, reference_fps_short_raw.json
                          the same two for the short-cue clip

With ``--language ch``, the fixtures of the default language instead:

  bands_ch.npz            three CJK cue bands (1280 x 104, white fill, a
                          2 px black outline, 44 px cells), drawn with the
                          JAX package's stroke composer
                          (``vse_tpu.core.strokefont``), since no font on
                          the box covers CJK; drawn at 4x and downsampled
                          (Lanczos), so the strokes are anti-aliased as a
                          font's are
  recipe_ch.json          the keyframe clip of ``recipe.json`` with the ch
                          cues and the area narrowed to x 440-840 around
                          them
  recipe_ch_fps_short.json  the no-area clip of ``recipe_fps_short.json``
                          with the ch cues (56 frames each), the committed
                          watermark and sign of ``bands_fps.npz``
  reference_ch.srt        extract CLIP --area 600,704,440,840 --mode fast
                          --language ch
  reference_ch_fps_short.srt, reference_ch_fps_short_raw.json
                          extract CLIP_FPS --language ch, and its records
                          before the filters

With ``--language <family>``, for one of the ten non-CJK families (latin,
cyrillic, devanagari, arabic, korean, el, ta, te, ka, th), the family's
keyframe fixture instead, each family a key of three shared files:

  bands_scripts.npz       ``<family>_band0..2``: three cues of real words
                          (``SCRIPT_CUES``), drawn with the renderer the
                          family's head was trained with
                          (``vse_tpu/train/synth.py::render_line``): DejaVu
                          Sans through PIL for latin, cyrillic, el and ka
                          (arabic the same, right to left through raqm, or
                          its shaped forms from ``core/arabic.py::
                          render_forms`` without raqm), the hangul stroke
                          composer for korean, the stroke fonts of
                          ``core/strokefont.py`` for th, devanagari, ta and
                          te (both composers at 4x, then downsampled, as
                          for ch)
  recipe_scripts.json     ``{family: recipe}``: the keyframe clip of
                          ``recipe.json`` with the family's cues, its
                          language code, and its subtitle area: full width,
                          or narrowed around the cues where the scan's 2%
                          text-cell vote would miss a cue over 1280 px
                          (ROADMAP fault 8)
  reference_scripts.json  ``{family: {"language", "srt", "lines"}}``: the
                          JAX CLI's SRT of ``extract CLIP --area A --mode
                          fast --language CODE`` (word segmentation on), and
                          the JAX extractor's OCR lines of every keyframe
                          sample, [frame_no, [xmin, xmax, ymin, ymax],
                          text, score], in sample order

With ``--language japan`` or ``--language chinese_cht``, the last two CJK
families' keyframe fixtures, as keys of the same three files: three cues
each (``CJK_CUES``: kana and kanji for japan, traditional characters for
chinese_cht), drawn as ch's are with the stroke composer (kana from
``vse_tpu/core/kana.py``) at 4x and downsampled, the area narrowed to the
cues' ink plus 40 px.

With ``--many``, the JAX package's ``extract_many`` references
(``vse_tpu.pipeline.multistream.extract_many``, default config, en, mode
fast) on clips written losslessly as for the CLI:

  reference_many.json     ``{"keyframe": {recipe: srt}, "fps": {recipe:
                          srt}}``: the keyframe strategy on
                          ``recipe.json`` and ``recipe_fps_short.json``,
                          both given ``recipe.json``'s area (the short
                          clip's watermark and sign lie outside its upload
                          band), and the fps strategy on ``recipe_fps.json``
                          and ``recipe_fps_short.json`` with no area

With ``--sync``, the sync phase's references, on the job that
``vse_tpu_torch/sync/synth.py`` makes from ``SYNC_SEED`` (two 24-minute
WAVs, the second with a 3.2 s insert at 11 minutes, a script of ~300 cues,
and two 20 s 720p clips with scene cuts, the second with a 3.2 s insert):

  reference_sync.json     ``{"seed", "wav_sha256": {"src", "dst"},
                          "keyframes": {"src", "dst"}, "srt",
                          "srt_device", "argv"}``: the JAX package's
                          ``make_keyframes`` logs of the two clips (each
                          written losslessly), and its ``sync.runner.run``
                          output with those logs (``--src-fps 25
                          --dst-fps 25 --kf-mode all``), once with the
                          numpy matcher and once with the device matcher
                          (``VSE_SYNC_DEVICE=1``, XLA's FFT on the CPU)

With ``--accurate``, the references of modes accurate and auto, made with
the JAX package's engine given the server det's weights (restored from
``checkpoints/det_server`` by ``tools/export_torch_weights.py``; the JAX
registry's own restore of that checkpoint fails and falls back to the
mobile det, ROADMAP fault 15), default config for en:

  reference_accurate.json ``{"keyframe_accurate", "keyframe_auto",
                          "fps_short_accurate": {"srt", "lines"},
                          "beam": {"frames", "band", "records", "ids"},
                          "small": {"recipe", "srt", "lines", "raw",
                          "many"}}``: ``extract CLIP --area 600,704,0,1280
                          --mode accurate`` on ``recipe.json`` (lines: every
                          OCR line of every frame the tracker was fed),
                          ``--mode auto`` on the same clip with the server
                          det (accelerated; lines: every keyframe sample's),
                          ``--mode accurate`` without an area on
                          ``recipe_fps_short.json`` (lines: every OCR line
                          before the filters); ``OcrEngine(mode=accurate,
                          decode="beam")`` on 8 band frames of the keyframe
                          clip (each frame's [box, text, score] lines and
                          the beam's ids); and the CPU tests' small accurate
                          clip (``SMALL_RECIPE``: 24 frames of 256 x 64, the
                          sign and the watermark as two cues, two boxes a
                          frame), its SRT, tracker lines and raw records
  det_server_probe.npz    a [1, 64, 320] crop of the keyframe clip, the
                          JAX server det's bf16 probability map of it and
                          the boxes and valid mask of its postprocess

With ``--train``, the training phase's fixtures (en, seed 0):

  train_rec_en.npz        ``images`` [256, 48, 320, 3] u8 and ``texts``:
                          4 batches of 64 crops drawn by the JAX package's
                          ``TextRenderer`` with ``rec_render_config()`` in
                          ``load_or_render_rec_dataset``'s curriculum order
                          (the file that loader caches for ``--pregen 4
                          --batch 64``)
  train_det_en.npz        16 frames [256, 448, 3] u8 and their four f16 DB
                          label maps, as ``load_or_render_det_dataset``
                          writes them
  train_rec_init.npz      ``train_rec``'s initial variables for en, seed 0
                          (flat flax keys, the layout of
                          ``checkpoints_torch/rec_*.npz``)
  reference_train.json    ``{"rec": {"indices", "losses", "probe_texts",
                          ...}}``: ``train_rec``'s own ``step_core`` and
                          optimizer for ``steps=300, lr=1e-3`` (captured from
                          ``vse_tpu.train.pretrain.train_rec``), run 20 steps
                          from that init on fixed batches of 64 un-augmented
                          crops (``indices``); each step's loss, and the
                          greedy reads of the 4 probe crops (``train_rec``'s
                          probe, the first 4) after step 20 (empty: 20 steps
                          from scratch read nothing); then ``head_losses``
                          and ``head_probe_texts``: the same step, with a
                          fresh optimizer, run 5 steps from the committed en
                          head (orbax, ``checkpoints/rec_en_mobile``), and
                          the probe's reads after them (real text). (From
                          the trained head these crops cost ~1e-4 a
                          sequence, under the f32 resolution of the CTC
                          loss, so the loss parity starts from the init.)

Datasets and the init that exist are reused as committed.

With ``--joint``, the joint det + rec step's fixtures
(``vse_tpu.train.steps``, en, seed 0):

  train_joint_init.npz    ``init_state``'s variables for
                          ``make_models(vocab)`` with the en training
                          charset (case folded, no space class): flat flax
                          keys under ``det/`` and ``rec/``
  reference_joint.json    ``{"full": ...}``: the losses (and ``det_loss``,
                          ``rec_loss``) of 5 ``make_train_step`` steps from
                          that init on one fixed batch at full width (det
                          16 x 256 x 448 from ``train_det_en.npz``,
                          normalized as the det device loop normalizes; rec
                          64 x 48 x 320, the first 64 crops of
                          ``train_rec_en.npz``), with the bf16 models of
                          ``make_models`` (the JAX step's) and with the
                          same modules at ``dtype=float32``; ``{"tiny":
                          ...}``: the same at ``tests/test_train_and_entry.py``'s
                          shapes (``combined_batch(4)``, det 32 x 64, rec
                          48 x 64)
  reference_joint_tiny.npz  that tiny batch and, from the f32 run, each
                          trainable parameter's change over the 5 steps
                          (f16, flat flax keys under ``det/`` and ``rec/``)

With ``--joint-grads``, the f32 step's gradients at the first step on that
tiny batch from the committed ``train_joint_init.npz`` (the optimizer
replaced by one that keeps the gradients it is given):

  reference_joint_grads.npz  ``scale/<key>``: each trainable parameter's
                          largest gradient magnitude (f32); ``grad/<key>``:
                          its gradient over that scale (f16)

Band files that exist are reused as committed (they are rendered only when
they are missing; a family whose bands are missing from
``bands_scripts.npz`` is drawn and added). Run it with JAX on the CPU (it needs PIL, OpenCV and the
en and ch rec heads):

    JAX_PLATFORMS=cpu python tools/make_torch_smoke_fixture.py [--language ch|<family>] [--many]
    JAX_PLATFORMS=cpu python tools/make_torch_smoke_fixture.py --accurate
    JAX_PLATFORMS=cpu python tools/make_torch_smoke_fixture.py --train
    JAX_PLATFORMS=cpu python tools/make_torch_smoke_fixture.py --joint
    JAX_PLATFORMS=cpu python tools/make_torch_smoke_fixture.py --joint-grads
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

OUT = os.path.join(ROOT, "vse_tpu_torch", "assets", "smoke")
FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
W, H, FPS, N = 1280, 720, 25, 500
SYNC_SEED = 10
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
# the no-area clip's extra lines: (band, text, width x height, origin [y, x],
# first, last). At stride 8 (25 fps // 3 a second) the watermark is on all
# 63 sampled frames, the sign on 5.
# the short-cue clip: each cue's first 56 frames. Three cues of 7 samples
# unite into one coordinate group of 21 records with 3 texts, which the
# auto watermark policy keeps (it drops a group of >= 10 records with at
# most a tenth as many distinct texts).
SHORT = 56
# the ch cues: CJK only (the stroke composer draws no ASCII), fixed before
# either package read them
CUES_CH = [
    ("今天天气很好", 26, 150),
    ("我们明天见", 176, 300),
    ("你好世界", 351, 450),
]
CH_CELL = 44
CH_SUPERSAMPLE = 4
# The keyframe scan counts a frame as text when over 2% of the area's 4 x 8
# cells are 40% edge pixels. The composer's lines are aliased and its cues
# are 4-6 characters, 190-285 px wide: drawn directly, their text-cell
# share over a 1280-wide area is 0.07-0.24%. Anti-aliased and in an area
# of 400 x 104 around them, it is 2.9-6.1%.
CH_AREA_X = (440, 840)
# the ten non-CJK families: (language code, three cues), fixed before either
# package read them; the cue frames are those of CUES
SCRIPT_CUES = {
    "latin": ("fr", ["bonjour tout le monde", "merci beaucoup", "à bientôt mes amis"]),
    "cyrillic": ("ru", ["привет мир", "как дела", "до свидания"]),
    "devanagari": ("hi", ["नमस्ते दुनिया", "धन्यवाद", "फिर मिलेंगे"]),
    "arabic": ("ar", ["مرحبا بالعالم", "شكرا جزيلا", "الحلقة 12"]),
    "korean": ("korean", ["안녕하세요", "감사합니다", "잘 가요"]),
    "el": ("el", ["γεια σου κόσμε", "καλημέρα", "ευχαριστώ πολύ"]),
    "ta": ("ta", ["வணக்கம்", "நன்றி", "போய் வருகிறேன்"]),
    "te": ("te", ["నమస్కారం", "ధన్యవాదాలు", "మళ్ళీ కలుద్దాం"]),
    "ka": ("ka", ["გამარჯობა", "მადლობა", "ნახვამდის"]),
    "th": ("th", ["สวัสดี", "ขอบคุณ", "ลาก่อน"]),
}
# the last two CJK families: (language code, three cues), drawn as the
# stroke families are. japan's first cues (こんにちは世界, ありがとう, また明日ね)
# all scored under the drop score (0.31-0.39) in the JAX engine, which left
# its SRT empty; these were chosen, before the port read any, so that two
# cues clear it, with widths close enough (180-220 px) that the narrowed
# area keeps the shortest over the scan's 2% vote
CJK_CUES = {
    "japan": ("japan", ["学生です", "ありがとう", "さようなら"]),
    "chinese_cht": ("chinese_cht", ["今天天氣很好", "我們明天見", "你好世界"]),
}
SCRIPT_CELL = 44  # stroke fonts' cell height, as ch's
HANGUL_SIZE = 40
# the smallest full-width text-cell share (of the scan's 4 x 8 cells) a cue
# must reach for the area to stay 1280 px wide; the vote is at 2%
TEXT_CELL_MARGIN = 0.03
# the CPU tests' accurate clip: the sign and the watermark of bands_fps.npz
# as two cues of 7 frames, 6 frames apart (over the tracker's 5-frame
# grace at 25 fps), in a frame as small as the det's 32-pixel canvas steps
# allow (the area's upload band is the whole frame: a 64 x 256 canvas); its
# config keeps two boxes a frame, so each OCR chunk reads 16 crops, not 64
SMALL_RECIPE = {
    "width": 256, "height": 64, "fps": FPS, "n_frames": 24, "background": list(BG),
    "band_origin": [8, 8], "band_files": ["bands_fps.npz"], "area": [4, 60, 0, 256],
    "cues": [{"band": "scene", "text": "CITY CAFE", "first": 2, "last": 8, "origin": [8, 8]},
             {"band": "watermark", "text": "VSE TV", "first": 15, "last": 21,
              "origin": [8, 48]}],
}
SMALL_CONFIG = {"max_boxes_per_frame": 2}
# the beam records' frames (0-based) of the keyframe clip, and its upload band
BEAM_FRAMES = [10, 30, 60, 120, 200, 250, 380, 420]
BEAM_BAND = (568, 720)
EXTRAS = [
    ("watermark", "VSE TV", (160, 48), [24, 1080], 1, N),
    ("scene", "CITY CAFE", (240, 48), [330, 520], 201, 240),
]


def render_band(text: str, w: int = W, h: int = BAND_H, y: int = 30) -> np.ndarray:
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.truetype(FONT, 36)
    img = Image.new("RGB", (w, h), BG)
    d = ImageDraw.Draw(img)
    tw = d.textlength(text, font=font)
    d.text(((w - tw) // 2, y), text, font=font, fill=(255, 255, 255),
           stroke_width=2, stroke_fill=(0, 0, 0))
    return np.asarray(img, np.uint8)


def render_band_ch(text: str) -> np.ndarray:
    """A ch cue band, drawn with the stroke composer at ``CH_CELL`` px
    cells, centred as ``render_band`` centres, at ``CH_SUPERSAMPLE`` times
    the size and then downsampled."""
    from PIL import Image, ImageDraw

    from vse_tpu.core.strokefont import draw_text, line_width, stroke_script_for

    k = CH_SUPERSAMPLE
    script = stroke_script_for("ch")
    img = Image.new("RGB", (W * k, BAND_H * k), BG)
    tw = line_width(script, text, CH_CELL * k)
    draw_text(ImageDraw.Draw(img), ((W * k - tw) // 2, 30 * k), text, CH_CELL * k,
              script, fill=(255, 255, 255), stroke_width=2 * k, stroke_fill=(0, 0, 0))
    return np.asarray(img.resize((W, BAND_H), Image.LANCZOS), np.uint8)


def render_band_script(family: str, text: str) -> np.ndarray:
    """A cue band of one of the ten non-CJK families, centred as
    ``render_band`` centres, with that family's training renderer."""
    from PIL import Image, ImageDraw, ImageFont, features

    if family in ("latin", "cyrillic", "el", "ka"):
        return render_band(text)
    if family == "arabic":
        font = ImageFont.truetype(FONT, 36)
        img = Image.new("RGB", (W, BAND_H), BG)
        d = ImageDraw.Draw(img)
        if features.check("raqm"):  # raqm shapes the logical text itself
            glyphs, kw = text, {"direction": "rtl"}
        else:
            from vse_tpu.core.arabic import render_forms

            glyphs, kw = render_forms(text)[0], {}
        tw = d.textlength(glyphs, font=font, **kw)
        d.text(((W - tw) // 2, 30), glyphs, font=font, fill=(255, 255, 255),
               stroke_width=2, stroke_fill=(0, 0, 0), **kw)
        return np.asarray(img, np.uint8)
    k = CH_SUPERSAMPLE
    img = Image.new("RGB", (W * k, BAND_H * k), BG)
    d = ImageDraw.Draw(img)
    if family == "korean":
        from vse_tpu.core.hangul import render_hangul_text, text_width

        font = ImageFont.truetype(FONT, 36 * k)
        tw = text_width(text, HANGUL_SIZE * k, font, d)
        render_hangul_text(d, ((W * k - tw) // 2, 30 * k), text, HANGUL_SIZE * k, font,
                           fill=(255, 255, 255), stroke_width=2 * k, stroke_fill=(0, 0, 0))
    else:
        from vse_tpu.core.strokefont import draw_text, line_width, stroke_script_for

        script = stroke_script_for(family)
        tw = line_width(script, text, SCRIPT_CELL * k)
        draw_text(d, ((W * k - tw) // 2, 30 * k), text, SCRIPT_CELL * k, script,
                  fill=(255, 255, 255), stroke_width=2 * k, stroke_fill=(0, 0, 0))
    return np.asarray(img.resize((W, BAND_H), Image.LANCZOS), np.uint8)


def script_area(bands: list) -> list:
    """The subtitle area for a family's three bands: full width when the
    JAX scan's text-cell share of each band over 1280 px clears
    ``TEXT_CELL_MARGIN``, else the union of the cues' ink columns plus 40
    px a side, on multiples of 8."""
    from vse_tpu.kernels.keyframe import scan_stats_u8

    full = min(float(scan_stats_u8(np.stack([b, b]))[1, 1]) for b in bands)
    if full >= TEXT_CELL_MARGIN:
        return [BAND_Y, BAND_Y + BAND_H, 0, W]
    ink = np.nonzero(np.any([np.any(b != np.asarray(BG, np.uint8), axis=(0, 2))
                             for b in bands], axis=0))[0]
    x0 = max(0, (int(ink[0]) - 40) // 8 * 8)
    x1 = min(W, -(-(int(ink[-1]) + 41) // 8) * 8)
    narrow = min(float(scan_stats_u8(np.stack([b[:, x0:x1]] * 2))[1, 1]) for b in bands)
    print(f"text-cell share over 1280 px {full:.4f}; over x {x0}-{x1} {narrow:.4f}")
    return [BAND_Y, BAND_Y + BAND_H, x0, x1]


def jax_keyframe_reference(frames: np.ndarray, area: list, language: str):
    """(SRT, lines) of the JAX CLI's ``extract CLIP --area A --mode fast
    --language CODE`` on the clip: the lines are its extractor's OCR lines
    of every keyframe sample, before the gate, [frame_no, [xmin, xmax,
    ymin, ymax], text, score]."""
    from vse_tpu.cli import main as vse_main
    from vse_tpu.pipeline.extractor import SubtitleExtractor

    lines = []
    refine = SubtitleExtractor.refine_keyframe_spans

    def keep_lines(self, spans, samples):
        # samples: [(span, frame_no, dt_box, rec_res, frame)]
        lines.extend(
            [int(s[1]), [int(q[0][0]), int(q[1][0]), int(q[0][1]), int(q[2][1])], t, float(p)]
            for s in samples for q, (t, p) in zip(s[2], s[3]))
        return refine(self, spans, samples)

    SubtitleExtractor.refine_keyframe_spans = keep_lines
    try:
        with tempfile.TemporaryDirectory() as tmp:
            clip = os.path.join(tmp, "smoke.avi")
            write_lossless(frames, clip)
            rc = vse_main(["extract", clip, "--area", ",".join(str(v) for v in area),
                           "--mode", "fast", "--language", language])
            if rc != 0:
                raise SystemExit(f"vse_tpu.cli extract returned {rc}")
            with open(os.path.join(tmp, "smoke.srt"), encoding="utf-8") as f:
                srt = f.read()
    finally:
        SubtitleExtractor.refine_keyframe_spans = refine
    print(f"--- {language}\n{srt}")
    return srt, lines


def main_script(family: str) -> None:
    from vse_tpu_torch.video.synth import compose_frames

    language, texts = {**SCRIPT_CUES, **CJK_CUES}[family]
    path = os.path.join(OUT, "bands_scripts.npz")
    all_bands = {}
    if os.path.exists(path):
        with np.load(path) as z:
            all_bands = {k: np.asarray(z[k]) for k in z.files}
    names = [f"{family}_band{i}" for i in range(3)]
    if not all(n in all_bands for n in names):
        all_bands.update({n: render_band_script(family, t) for n, t in zip(names, texts)})
        np.savez_compressed(path, **dict(sorted(all_bands.items())))
    bands = {n: all_bands[n] for n in names}
    recipe = keyframe_recipe([
        {"band": n, "text": t, "first": a, "last": b}
        for n, t, (_, a, b) in zip(names, texts, CUES)])
    recipe.update(language=language, band_files=["bands_scripts.npz"],
                  area=script_area([bands[n] for n in names]))
    recipes = read_json("recipe_scripts.json")
    recipes[family] = recipe
    write_json("recipe_scripts.json", dict(sorted(recipes.items())))
    srt, lines = jax_keyframe_reference(compose_frames(bands, recipe), recipe["area"],
                                        language)
    refs = read_json("reference_scripts.json")
    refs[family] = {"language": language, "srt": srt, "lines": lines}
    with open(os.path.join(OUT, "reference_scripts.json"), "w", encoding="utf-8") as f:
        json.dump(dict(sorted(refs.items())), f, ensure_ascii=False)
        f.write("\n")
    print(f"--- {family}: {len(refs[family]['lines'])} lines, texts "
          f"{sorted(set(r[2] for r in refs[family]['lines']))}")


def read_json(name: str) -> dict:
    path = os.path.join(OUT, name)
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_or_render(name: str, render) -> dict:
    path = os.path.join(OUT, name)
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    bands = render()
    np.savez_compressed(path, **bands)
    return bands


def write_json(name: str, obj: dict) -> None:
    with open(os.path.join(OUT, name), "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")


def jax_reference(frames: np.ndarray, out_name: str, *flags: str) -> None:
    """Run the JAX package's CLI on the clip and keep its SRT."""
    from vse_tpu.cli import main as vse_main

    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "smoke.avi")
        write_lossless(frames, clip)
        rc = vse_main(["extract", clip, *flags])
        if rc != 0:
            raise SystemExit(f"vse_tpu.cli extract returned {rc}")
        shutil.copyfile(os.path.join(tmp, "smoke.srt"), os.path.join(OUT, out_name))
    with open(os.path.join(OUT, out_name), encoding="utf-8") as f:
        print(f"--- {out_name}\n{f.read()}")


def jax_fps_records(frames: np.ndarray, out_name: str, language: str = "en") -> None:
    """The JAX extractor's fps-strategy records of the clip, before the
    filters: [frame, box, text, score], the score being the line's
    recognition score as the gate saw it."""
    from vse_tpu.core.config import VseConfig
    from vse_tpu.pipeline.extractor import SubtitleExtractor

    with tempfile.TemporaryDirectory() as tmp:
        clip = os.path.join(tmp, "smoke.avi")
        write_lossless(frames, clip)
        ex = SubtitleExtractor(clip, None, VseConfig(language=language))
        scores = []
        gate = ex._gate_lines

        def keep_scores(*args, **kwargs):
            kept = gate(*args, **kwargs)
            scores.extend(float(prob) for _, _, prob in kept)
            return kept

        ex._gate_lines = keep_scores
        ex.extract_frame_by_fps()
    if len(scores) != len(ex.raw_records):
        raise SystemExit(f"{len(scores)} scores for {len(ex.raw_records)} records")
    records = [[r.frame_no, list(r.coord), r.text, s] for r, s in zip(ex.raw_records, scores)]
    with open(os.path.join(OUT, out_name), "w", encoding="utf-8") as f:
        json.dump(records, f, ensure_ascii=False)
        f.write("\n")
    print(f"--- {out_name}: {len(records)} records, texts "
          f"{sorted(set(r[2] for r in records))}")


def write_lossless(frames: np.ndarray, path: str, recipe: dict = None) -> None:
    import cv2

    h, w = frames.shape[1:3]
    fps = float(recipe["fps"]) if recipe else float(FPS)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), fps, (w, h))
    for f in frames:
        vw.write(np.ascontiguousarray(f[:, :, ::-1]))
    vw.release()
    cap = cv2.VideoCapture(path)
    for i, f in enumerate(frames):
        ok, g = cap.read()
        if not ok or not np.array_equal(g[:, :, ::-1], f):
            raise SystemExit(f"{path}: frame {i} did not decode losslessly")
    cap.release()


def cue_list(cues) -> list:
    return [{"band": f"band{i}", "text": t, "first": a, "last": b}
            for i, (t, a, b) in enumerate(cues)]


def keyframe_recipe(cues: list) -> dict:
    return {
        "width": W, "height": H, "fps": FPS, "n_frames": N,
        "background": list(BG), "band_origin": [BAND_Y, 0],
        "area": [BAND_Y, BAND_Y + BAND_H, 0, W], "cues": cues,
    }


def short_recipe(recipe: dict, band_file: str) -> dict:
    """The no-area clip: the recipe's cues cut to ``SHORT`` frames, the
    watermark and the sign, no area."""
    out = dict(recipe, band_files=[band_file, "bands_fps.npz"], cues=[
        dict(c, last=c["first"] + SHORT - 1) for c in recipe["cues"]] + [
        {"band": name, "text": text, "first": a, "last": b, "origin": origin}
        for name, text, _, origin, a, b in EXTRAS])
    del out["area"]
    return out


def main_ch() -> None:
    from vse_tpu_torch.video.synth import compose_frames

    bands = load_or_render("bands_ch.npz", lambda: {
        f"band{i}": render_band_ch(t) for i, (t, _, _) in enumerate(CUES_CH)})
    extras = load_or_render("bands_fps.npz", lambda: None)
    recipe = keyframe_recipe(cue_list(CUES_CH))
    recipe["band_files"] = ["bands_ch.npz"]
    recipe["area"][2:] = list(CH_AREA_X)
    write_json("recipe_ch.json", recipe)
    recipe_short = short_recipe(recipe, "bands_ch.npz")
    write_json("recipe_ch_fps_short.json", recipe_short)
    area = ",".join(str(v) for v in recipe["area"])
    jax_reference(compose_frames(bands, recipe), "reference_ch.srt", "--area", area,
                  "--mode", "fast", "--language", "ch")
    frames_short = compose_frames({**bands, **extras}, recipe_short)
    jax_reference(frames_short, "reference_ch_fps_short.srt", "--language", "ch")
    jax_fps_records(frames_short, "reference_ch_fps_short_raw.json", "ch")


def jax_extract_many(clips: dict, area) -> dict:
    """{recipe name: SRT} of the JAX package's ``extract_many`` over the
    clips, each written losslessly, with the default config for en (mode
    fast), every clip given ``area`` (or none)."""
    from vse_tpu.core.config import VseConfig
    from vse_tpu.core.subtitle_area import SubtitleArea
    from vse_tpu.pipeline.multistream import extract_many

    names = sorted(clips)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, name in enumerate(names):
            paths.append(os.path.join(tmp, f"clip{i}.avi"))
            write_lossless(clips[name], paths[-1])
        areas = [SubtitleArea(*area) if area else None for _ in names]
        out = extract_many(paths, sub_areas=areas, config=VseConfig(language="en"))
        srts = {}
        for name, path in zip(names, paths):
            with open(out[path], encoding="utf-8") as f:
                srts[name] = f.read()
            print(f"--- extract_many {name}, area {area}\n{srts[name]}")
    return srts


def main_many() -> None:
    from vse_tpu_torch.video.synth import compose_frames, load_fixture

    def clip(name):
        bands, recipe = load_fixture(recipe=name)
        return compose_frames(bands, recipe), recipe

    kf, recipe = clip("recipe.json")
    short, _ = clip("recipe_fps_short.json")
    refs = {"keyframe": jax_extract_many({"recipe.json": kf, "recipe_fps_short.json": short},
                                         recipe["area"])}
    del kf
    fps, _ = clip("recipe_fps.json")
    refs["fps"] = jax_extract_many({"recipe_fps.json": fps, "recipe_fps_short.json": short},
                                   None)
    with open(os.path.join(OUT, "reference_many.json"), "w", encoding="utf-8") as f:
        json.dump(refs, f, indent=1, ensure_ascii=False)
        f.write("\n")


def sync_argv(src: str, dst: str, script: str, out: str, kf_src: str, kf_dst: str) -> list:
    """The re-timer's arguments for the sync phase's job (both packages)."""
    return ["--src", src, "--dst", dst, "--script", script, "-o", out,
            "--src-keyframes", kf_src, "--dst-keyframes", kf_dst,
            "--src-fps", "25", "--dst-fps", "25", "--kf-mode", "all"]


def main_sync() -> None:
    from vse_tpu.sync.cli import create_arg_parser
    from vse_tpu.sync.demux import make_keyframes
    from vse_tpu.sync.runner import run
    from vse_tpu_torch.sync import synth

    ref = {"seed": SYNC_SEED, "keyframes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        src, dst, ref["wav_sha256"] = synth.write_wav_pair(tmp, SYNC_SEED)
        script = os.path.join(tmp, "in.srt")
        synth.write_srt(script, synth.script_cues(SYNC_SEED))
        logs = {}
        for name in ("src", "dst"):
            clip = synth.scene_clip(SYNC_SEED, name)
            path = os.path.join(tmp, f"{name}.avi")
            write_lossless(clip.frames, path)
            del clip
            logs[name] = os.path.join(tmp, f"{name}.keyframes.txt")
            make_keyframes(path, logs[name])
            with open(logs[name], encoding="utf-8") as f:
                ref["keyframes"][name] = f.read()
        out = os.path.join(tmp, "out.srt")
        argv = sync_argv(src, dst, script, out, logs["src"], logs["dst"])
        ref["argv"] = sync_argv("SRC", "DST", "SCRIPT", "OUT", "KF_SRC", "KF_DST")
        for key, flag in (("srt", "0"), ("srt_device", "1")):
            os.environ["VSE_SYNC_DEVICE"] = flag
            run(create_arg_parser().parse_args(argv))
            with open(out, encoding="utf-8") as f:
                ref[key] = f.read()
        del os.environ["VSE_SYNC_DEVICE"]
    write_json("reference_sync.json", ref)
    print(f"--- reference_sync.json: keyframes {[k.count('i') for k in ref['keyframes'].values()]}, "
          f"{ref['srt'].count('-->')} cues, device matcher's SRT equal to numpy's: "
          f"{ref['srt'] == ref['srt_device']}")


def box_of(quad) -> list:
    return [int(quad[0][0]), int(quad[1][0]), int(quad[0][1]), int(quad[2][1])]


def jax_server_engine(mode: str, decode: str = "greedy", **config):
    """The JAX engine for en in ``mode`` (accelerated) with ``config``'s
    fields, given the server det's restored weights when the mode resolves
    to it."""
    from export_torch_weights import restore_det_server
    from vse_tpu.core.config import Mode, VseConfig
    from vse_tpu.core.registry import models_root, resolve
    from vse_tpu.pipeline.ocr_engine import OcrEngine

    mode = Mode(mode)
    params = None
    if resolve("en", mode, True).det_variant == "server":
        params = restore_det_server(os.path.join(models_root(), "det_server"))
    return OcrEngine(language="en", mode=mode,
                     config=VseConfig(language="en", mode=mode, **config),
                     det_params=params, accelerated=True, decode=decode)


def jax_mode_run(frames: np.ndarray, recipe: dict, area, mode: str, engine, hook: str,
                 **config):
    """(SRT, lines, raw records) of the JAX extractor in ``mode`` on the
    clip with ``area`` (or none), the default config for en (with
    ``config``'s fields), its stream on full batches. ``hook`` names the lines kept: "feed" (every line of every
    frame the accurate tracker is fed), "refine" (every keyframe sample's)
    or "gate" (every line recorded, with its score, before the filters)."""
    from vse_tpu.core.config import Mode, VseConfig
    from vse_tpu.core.subtitle_area import SubtitleArea
    from vse_tpu.pipeline import extractor as jx
    from vse_tpu.video import decode

    lines = []
    saved = {name: getattr(cls, name) for cls, name in (
        (jx.DetSpanTracker, "feed"), (jx.SubtitleExtractor, "refine_keyframe_spans"),
        (jx.SubtitleExtractor, "_gate_and_record"))}

    def feed(self, frame_no, dt_box, rec_res):
        lines.extend([frame_no, box_of(q), t, float(p)] for q, (t, p) in zip(dt_box, rec_res))
        return saved["feed"](self, frame_no, dt_box, rec_res)

    def refine(self, spans, samples):
        lines.extend([int(s[1]), box_of(q), t, float(p)]
                     for s in samples for q, (t, p) in zip(s[2], s[3]))
        return saved["refine_keyframe_spans"](self, spans, samples)

    def gate(self, frame_no, dt_box, rec_res, *a, **kw):
        lines.extend([frame_no, list(b), t, float(p)] for b, t, p in self._gate_lines(dt_box, rec_res))
        return saved["_gate_and_record"](self, frame_no, dt_box, rec_res, *a, **kw)

    native = decode.native_available
    decode.native_available = lambda: False
    if hook == "feed":
        jx.DetSpanTracker.feed = feed
    elif hook == "refine":
        jx.SubtitleExtractor.refine_keyframe_spans = refine
    else:
        jx.SubtitleExtractor._gate_and_record = gate
    try:
        with tempfile.TemporaryDirectory() as tmp:
            clip = os.path.join(tmp, "clip.avi")
            write_lossless(frames, clip, recipe)
            ex = jx.SubtitleExtractor(clip, SubtitleArea(*area) if area else None,
                                      VseConfig(language="en", mode=Mode(mode), **config),
                                      engine=engine)
            with open(ex.run(), encoding="utf-8") as f:
                srt = f.read()
            raw = [[r.frame_no, list(r.coord), r.text] for r in ex.raw_records]
    finally:
        decode.native_available = native
        jx.DetSpanTracker.feed = saved["feed"]
        jx.SubtitleExtractor.refine_keyframe_spans = saved["refine_keyframe_spans"]
        jx.SubtitleExtractor._gate_and_record = saved["_gate_and_record"]
    print(f"--- {mode}, area {area}: {len(lines)} lines\n{srt}")
    return srt, lines, raw


def main_accurate() -> None:
    import jax
    import jax.numpy as jnp

    from export_torch_weights import restore_det_server
    from vse_tpu.core.registry import models_root
    from vse_tpu.models.db_detector import DBDetector
    from vse_tpu.ops import ctc
    from vse_tpu.ops.db_postprocess import db_postprocess
    from vse_tpu.ops.image import normalize_det
    from vse_tpu_torch.video.synth import compose_frames, load_fixture

    refs = {}
    accurate = jax_server_engine("accurate")
    bands, recipe = load_fixture()
    frames = compose_frames(bands, recipe)
    srt, lines, _ = jax_mode_run(frames, recipe, recipe["area"], "accurate", accurate, "feed")
    refs["keyframe_accurate"] = {"srt": srt, "lines": lines}
    srt, lines, _ = jax_mode_run(frames, recipe, recipe["area"], "auto",
                                 jax_server_engine("auto"), "refine")
    refs["keyframe_auto"] = {"srt": srt, "lines": lines}

    # the beam decode on band frames, with the beam's ids
    beam = jax_server_engine("accurate", decode="beam")
    ids = []
    beam_fn = ctc.ctc_prefix_beam_decode

    def keep_ids(*a, **kw):
        out = beam_fn(*a, **kw)
        ids.append([int(i) for i in out[0]])
        return out

    ctc.ctc_prefix_beam_decode = keep_ids
    try:
        y0, y1 = BEAM_BAND
        res = beam.predict_batch(np.ascontiguousarray(frames[BEAM_FRAMES, y0:y1]), origin=(y0, 0))
    finally:
        ctc.ctc_prefix_beam_decode = beam_fn
    refs["beam"] = {"frames": BEAM_FRAMES, "band": list(BEAM_BAND), "ids": ids, "records": [
        [[box_of(q), t, float(p)] for q, (t, p) in zip(dt_box, rec_res)] for dt_box, rec_res in res]}
    print(f"--- beam: {refs['beam']['records']}")

    # the det alone on a small crop, with the real weights
    probe = np.ascontiguousarray(frames[40:41, 600:664, 300:620])
    variables = restore_det_server(os.path.join(models_root(), "det_server"))
    prob = jax.jit(DBDetector(variant="server").apply)(variables, normalize_det(jnp.asarray(probe)))
    boxes, _, valid = db_postprocess(prob, max_boxes=8, pool=8, num_sweeps=2)
    np.savez_compressed(os.path.join(OUT, "det_server_probe.npz"), frames=probe,
                        prob=np.asarray(prob, np.float32), boxes=np.asarray(boxes),
                        valid=np.asarray(valid))
    print(f"--- det probe: {int(np.asarray(valid).sum())} boxes {np.asarray(boxes)[np.asarray(valid)]}")
    del frames

    bands, recipe = load_fixture(recipe="recipe_fps_short.json")
    frames = compose_frames(bands, recipe)
    srt, lines, _ = jax_mode_run(frames, recipe, None, "accurate", accurate, "gate")
    refs["fps_short_accurate"] = {"srt": srt, "lines": lines}
    del frames
    refs["small"] = small_refs()
    with open(os.path.join(OUT, "reference_accurate.json"), "w", encoding="utf-8") as f:
        json.dump(refs, f, ensure_ascii=False)
        f.write("\n")


def small_refs() -> dict:
    """The small accurate clip's references (``SMALL_RECIPE``, config
    ``SMALL_CONFIG``): its SRT, tracker lines and raw records."""
    from vse_tpu_torch.video.synth import compose_frames, load_fixture

    bands = load_fixture(recipe="recipe_fps.json")[0]
    small = compose_frames(bands, SMALL_RECIPE)
    accurate = jax_server_engine("accurate", **SMALL_CONFIG)
    srt, lines, raw = jax_mode_run(small, SMALL_RECIPE, SMALL_RECIPE["area"], "accurate",
                                   accurate, "feed", **SMALL_CONFIG)
    print(f"--- small: {len(lines)} lines\n{srt}")
    return {"recipe": SMALL_RECIPE, "config": SMALL_CONFIG, "srt": srt, "lines": lines,
            "raw": raw}


TRAIN_SEED = 0
TRAIN_CROPS = 256  # --pregen 4 --batch 64
TRAIN_FRAMES = 16
PARITY_STEPS = 20
PARITY_BATCH = 64
HEAD_STEPS = 5


def jax_rec_step_core(dataset, steps: int = 300, lr: float = 1e-3):
    """``vse_tpu.train.pretrain.train_rec``'s own ``step_core``, its fresh
    initial variables and optimizer state for en (``steps``, ``lr``, seed
    0), captured where it hands them to the device loop."""
    import vse_tpu.train.device_loop as jdl
    import vse_tpu.train.pretrain as jp

    class Captured(Exception):
        pass

    seen = {}

    def capture(**kw):
        seen.update(kw)
        raise Captured()

    saved = (jp.load_or_render_rec_dataset, jdl.run_rec_device_loop, os.environ.get("VSE_MODELS"))
    with tempfile.TemporaryDirectory() as tmp:
        jp.load_or_render_rec_dataset = lambda *a, **k: dataset
        jdl.run_rec_device_loop = capture
        os.environ["VSE_MODELS"] = tmp
        try:
            jp.train_rec("en", steps, PARITY_BATCH, lr, TRAIN_SEED, pregen=4, fresh=True)
        except Captured:
            pass
        finally:
            jp.load_or_render_rec_dataset, jdl.run_rec_device_loop = saved[:2]
            if saved[2] is None:
                del os.environ["VSE_MODELS"]
            else:
                os.environ["VSE_MODELS"] = saved[2]
    init = {"params": seen["params"], "batch_stats": seen["batch_stats"]}
    return seen["step_core"], init, seen["opt_state"], seen["labels"], seen["lengths"]


def main_train() -> None:
    import jax
    import jax.numpy as jnp

    from vse_tpu.core.charset import get_charset
    from vse_tpu.core.registry import init_or_load, models_root
    from vse_tpu.models.crnn import CRNNRecognizer
    from vse_tpu.ops.ctc import ctc_greedy_decode, decode_batch_to_texts
    from vse_tpu.train.pretrain import _rec_train_charset
    from vse_tpu.train.synth import SynthConfig, TextRenderer, rec_render_config

    rec_path = os.path.join(OUT, "train_rec_en.npz")
    det_path = os.path.join(OUT, "train_det_en.npz")
    if os.path.exists(rec_path):
        with np.load(rec_path) as z:
            images, texts = z["images"], [str(t) for t in z["texts"]]
    else:
        # the rec dataset, as load_or_render_rec_dataset renders it
        r = TextRenderer(_rec_train_charset("en", False, True), rec_render_config(),
                         seed=TRAIN_SEED)
        imgs, texts = [], []
        for bi in range(TRAIN_CROPS):
            r.cfg.difficulty = min(1.0, 2.0 * bi / TRAIN_CROPS)
            img, text = r.render_line()
            imgs.append(img)
            texts.append(text)
        images = np.stack(imgs)
        np.savez_compressed(rec_path, images=images, texts=np.array(texts))
    if not os.path.exists(det_path):
        # the det dataset, as load_or_render_det_dataset renders it
        r = TextRenderer(get_charset("en"), SynthConfig(det_h=256, det_w=448), seed=TRAIN_SEED)
        det = {k: [] for k in ("images", "gt_shrink", "gt_shrink_mask", "gt_thresh",
                               "gt_thresh_mask")}
        for _ in range(TRAIN_FRAMES):
            img, boxes = r.render_frame()
            det["images"].append(img)
            for k, v in r.det_labels(boxes).items():
                det[k].append(v)
        np.savez_compressed(det_path, images=np.stack(det.pop("images")),
                            **{k: np.stack(v).astype(np.float16) for k, v in det.items()})

    step_core, variables, opt_state, labels, lengths = jax_rec_step_core((images, texts))
    from flax.traverse_util import flatten_dict

    init_path = os.path.join(OUT, "train_rec_init.npz")
    if not os.path.exists(init_path):
        np.savez_compressed(init_path, **{
            "/".join(k): np.asarray(v)
            for k, v in flatten_dict(jax.device_get(variables)).items()})
    step = jax.jit(step_core)
    charset = _rec_train_charset("en", False, True)
    rec = CRNNRecognizer(vocab_size=charset.vocab_size, dtype=jnp.float32)
    indices = np.random.default_rng(12).integers(0, TRAIN_CROPS, (PARITY_STEPS, PARITY_BATCH))
    norm = ((images.astype(np.float32) / 255.0) - 0.5) / 0.5

    def run(variables, n):
        """``n`` steps from ``variables`` with a fresh optimizer state (the
        captured one is the optimizer's init: zero moments, count 0); each
        step's loss and the probe's reads after the last."""
        params, bs, state = variables["params"], variables["batch_stats"], opt_state
        losses = []
        for k in range(n):
            idx = indices[k]
            params, bs, state, loss = step(params, bs, state, jnp.asarray(norm[idx]),
                                           jnp.asarray(labels[idx]), jnp.asarray(lengths[idx]))
            losses.append(float(loss))
            print(f"step {k}: loss {losses[-1]:.6f}", flush=True)
        logits = rec.apply({"params": params, "batch_stats": bs}, jnp.asarray(norm[:4]))
        ids, mask, _ = ctc_greedy_decode(logits)
        return losses, decode_batch_to_texts(ids, mask, charset)

    losses, probe = run(variables, PARITY_STEPS)
    print("probe", probe, "truth", texts[:4])
    # the committed en head (orbax), restored as the JAX engine restores it
    head, loaded = init_or_load(rec, jnp.zeros((1, 48, 320, 3)),
                                os.path.join(models_root(), "rec_en_mobile"))
    assert loaded, "the JAX en head did not restore"
    head_losses, head_probe = run(head, HEAD_STEPS)
    print("probe from the en head", head_probe)
    refs = read_json("reference_train.json")
    refs["rec"] = {"steps": 300, "lr": 1e-3, "batch": PARITY_BATCH, "indices": indices.tolist(),
                   "losses": losses, "probe_texts": probe, "probe_truth": texts[:4],
                   "head_losses": head_losses, "head_probe_texts": head_probe}
    write_json("reference_train.json", refs)


JOINT_STEPS = 5
JOINT_TINY = dict(det_h=32, det_w=64, rec_h=48, rec_w=64, max_label_len=6, min_font=10,
                  max_font=14)


def flat_variables(tree, prefix: str = "") -> dict:
    """A flax variable tree as flat numpy arrays keyed ``a/b/c``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flat_variables(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def joint_full_batch() -> dict:
    """The full-width joint batch: the 16 det frames normalized as the det
    device loop normalizes them (no augmentation) and the first 64 rec crops
    with their labels."""
    from vse_tpu_torch.train import pretrain as port_pretrain

    charset = port_pretrain._rec_train_charset("en", False, True)
    with np.load(os.path.join(OUT, "train_det_en.npz")) as z:
        det = {k: z[k] for k in z.files}
    with np.load(os.path.join(OUT, "train_rec_en.npz")) as z:
        images, texts = z["images"][:PARITY_BATCH], [str(t) for t in z["texts"][:PARITY_BATCH]]
    mean, std = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])
    batch = {"det_images": ((det.pop("images").astype(np.float32) / 255.0 - mean) / std)
             .astype(np.float32)}
    batch.update({k: v.astype(np.float32) for k, v in det.items()})
    labels, lengths = port_pretrain.encode_labels(
        charset, texts, port_pretrain.rec_train_config(charset).max_label_len)
    batch["rec_images"] = ((images.astype(np.float32) / 255.0) - 0.5) / 0.5
    batch["labels"], batch["label_lengths"] = labels, lengths
    return batch


def main_joint() -> None:
    import jax
    import jax.numpy as jnp

    from vse_tpu.models.crnn import CRNNRecognizer
    from vse_tpu.models.db_detector import DBDetector
    from vse_tpu.train.pretrain import _rec_train_charset
    from vse_tpu.train.steps import init_state, make_models, make_train_step
    from vse_tpu.train.synth import SynthConfig, TextRenderer

    charset = _rec_train_charset("en", False, True)
    models = {
        "bf16": make_models(charset.vocab_size),
        "f32": (DBDetector(variant="mobile", train_outputs=True, dtype=jnp.float32),
                CRNNRecognizer(vocab_size=charset.vocab_size, dtype=jnp.float32)),
    }
    init = None
    refs = {"steps": JOINT_STEPS, "lr": 1e-3, "seed": TRAIN_SEED, "vocab": charset.vocab_size}
    tiny_batch = TextRenderer(charset, SynthConfig(**JOINT_TINY), seed=TRAIN_SEED).combined_batch(4)
    tiny_out = {f"batch/{k}": v for k, v in tiny_batch.items()}
    for size, batch in (("tiny", tiny_batch), ("full", joint_full_batch())):
        refs[size] = {"shapes": {k: list(v.shape) for k, v in batch.items()}}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        for dtype, (det, rec) in models.items():
            state, tx = init_state(det, rec, lr=refs["lr"], seed=TRAIN_SEED)
            variables = {f"{m}/{k}": v for m, tree in (("det", state.det_params),
                                                       ("rec", state.rec_params))
                         for k, v in flat_variables(jax.device_get(tree)).items()}
            if init is None:
                init = variables
                np.savez_compressed(os.path.join(OUT, "train_joint_init.npz"), **init)
            assert all(np.array_equal(init[k], v) for k, v in variables.items())
            step = make_train_step(det, rec, tx)
            run = {"loss": [], "det_loss": [], "rec_loss": []}
            for i in range(JOINT_STEPS):
                state, metrics = step(state, jb)
                for k in run:
                    run[k].append(float(metrics[k]))
                print(f"{size} {dtype} step {i}: loss {run['loss'][-1]:.6f}", flush=True)
            refs[size][dtype] = run
            if size == "tiny" and dtype == "f32":
                final = {f"{m}/{k}": v for m, tree in (("det", state.det_params),
                                                       ("rec", state.rec_params))
                         for k, v in flat_variables(jax.device_get(tree)).items()}
                tiny_out.update({f"delta/{k}": (v - init[k]).astype(np.float16)
                                 for k, v in final.items() if "/params/" in k})
        write_json("reference_joint.json", refs)
    np.savez_compressed(os.path.join(OUT, "reference_joint_tiny.npz"), **tiny_out)


def unflatten(flat: dict) -> dict:
    """Flat ``a/b/c`` arrays as a nested variable tree."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def main_joint_grads() -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from vse_tpu.models.crnn import CRNNRecognizer
    from vse_tpu.models.db_detector import DBDetector
    from vse_tpu.train.steps import TrainState, make_train_step

    refs = read_json("reference_joint.json")
    with np.load(os.path.join(OUT, "train_joint_init.npz")) as z:
        init = {k: z[k] for k in z.files}
    with np.load(os.path.join(OUT, "reference_joint_tiny.npz")) as z:
        batch = {k[6:]: jnp.asarray(z[k]) for k in z.files if k.startswith("batch/")}
    det = DBDetector(variant="mobile", train_outputs=True, dtype=jnp.float32)
    rec = CRNNRecognizer(vocab_size=refs["vocab"], dtype=jnp.float32)
    variables = {m: jax.tree.map(jnp.asarray, unflatten(
        {k[4:]: v for k, v in init.items() if k.startswith(m + "/")})) for m in ("det", "rec")}
    # keeps the gradients as its state and updates nothing
    keep = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))
    params = {m: v["params"] for m, v in variables.items()}
    state = TrainState(variables["det"], variables["rec"], keep.init(params),
                       jnp.zeros((), jnp.int32))
    state, metrics = make_train_step(det, rec, keep)(state, batch)
    np.testing.assert_allclose(float(metrics["loss"]), refs["tiny"]["f32"]["loss"][0], rtol=1e-6)
    out = {}
    for m, tree in jax.device_get(state.opt_state).items():
        for k, g in flat_variables(tree).items():
            scale = np.float32(np.abs(g).max())
            out[f"scale/{m}/params/{k}"] = scale
            out[f"grad/{m}/params/{k}"] = (g / scale if scale else g).astype(np.float16)
    np.savez_compressed(os.path.join(OUT, "reference_joint_grads.npz"), **out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--language", default="en",
                    choices=["en", "ch", *SCRIPT_CUES, *CJK_CUES])
    ap.add_argument("--many", action="store_true",
                    help="write the JAX extract_many references instead")
    ap.add_argument("--sync", action="store_true",
                    help="write the sync phase's references instead")
    ap.add_argument("--accurate", action="store_true",
                    help="write the accurate and auto modes' references instead")
    ap.add_argument("--train", action="store_true",
                    help="write the training phase's fixtures instead")
    ap.add_argument("--joint", action="store_true",
                    help="write the joint det + rec step's fixtures instead")
    ap.add_argument("--joint-grads", action="store_true",
                    help="write the joint step's first gradients instead")
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    if args.joint_grads:
        main_joint_grads()
        return
    if args.joint:
        main_joint()
        return
    if args.train:
        main_train()
        return
    if args.accurate:
        main_accurate()
        return
    if args.sync:
        main_sync()
        return
    if args.many:
        main_many()
        return
    if args.language == "ch":
        main_ch()
        return
    if args.language in SCRIPT_CUES or args.language in CJK_CUES:
        main_script(args.language)
        return
    from vse_tpu_torch.video.synth import compose_frames, noisy_band

    bands = load_or_render("bands.npz", lambda: {
        f"band{i}": render_band(t) for i, (t, _, _) in enumerate(CUES)})
    cues = cue_list(CUES)
    recipe = keyframe_recipe(cues)
    write_json("recipe.json", recipe)
    extras = load_or_render("bands_fps.npz", lambda: {
        name: render_band(text, w, h, 4) for name, text, (w, h), *_ in EXTRAS})
    recipe_fps = dict(recipe, band_files=["bands.npz", "bands_fps.npz"], cues=cues + [
        {"band": name, "text": text, "first": a, "last": b, "origin": origin}
        for name, text, _, origin, a, b in EXTRAS])
    del recipe_fps["area"]
    write_json("recipe_fps.json", recipe_fps)
    recipe_short = dict(recipe_fps, cues=[
        dict(c, last=c["first"] + SHORT - 1) if c["band"].startswith("band") else c
        for c in recipe_fps["cues"]])
    write_json("recipe_fps_short.json", recipe_short)

    from vse_tpu.kernels.keyframe import scan_stats_u8

    band = noisy_band()
    stats = np.concatenate([scan_stats_u8(band[i : i + 32]) for i in range(0, len(band), 32)])
    np.savez_compressed(os.path.join(OUT, "noisy_band.npz"), stats=stats)

    area = ",".join(str(v) for v in recipe["area"])
    frames = compose_frames(bands, recipe)
    jax_reference(frames, "reference.srt", "--area", area, "--mode", "fast",
                  "--language", "en", "--no-word-segmentation")
    jax_reference(frames, "reference_keyframe.srt", "--area", area, "--mode", "fast",
                  "--language", "en")
    frames_fps = compose_frames({**bands, **extras}, recipe_fps)
    jax_reference(frames_fps, "reference_fps.srt", "--language", "en")
    jax_fps_records(frames_fps, "reference_fps_raw.json")
    frames_short = compose_frames({**bands, **extras}, recipe_short)
    jax_reference(frames_short, "reference_fps_short.srt", "--language", "en")
    jax_fps_records(frames_short, "reference_fps_short_raw.json")


if __name__ == "__main__":
    main()
