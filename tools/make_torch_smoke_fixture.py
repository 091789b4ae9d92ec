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

Band files that exist are reused as committed (they are rendered only when
they are missing; a family whose bands are missing from
``bands_scripts.npz`` is drawn and added). Run it with JAX on the CPU (it needs PIL, OpenCV and the
en and ch rec heads):

    JAX_PLATFORMS=cpu python tools/make_torch_smoke_fixture.py [--language ch|<family>] [--many]
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--language", default="en",
                    choices=["en", "ch", *SCRIPT_CUES, *CJK_CUES])
    ap.add_argument("--many", action="store_true",
                    help="write the JAX extract_many references instead")
    ap.add_argument("--sync", action="store_true",
                    help="write the sync phase's references instead")
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
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
