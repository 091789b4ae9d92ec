"""The port's debug outputs against the JAX package's, on the CPU: the
OCR-loss debugger (``debug_ocr_loss``: a frame whose CJK-family read lost
every CJK character is written to ``loss/``), the raw-record dump
(``debug_no_delete_cache``: ``raw.txt``) and the subtitle-area preview
(``capture_frame_with_subtitle_area``). Both extractors run on the same
lossless clip with the same scripted OCR, so any difference is the port's."""

import os
import shutil

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vse_tpu.core.config import Mode as JaxMode
from vse_tpu.core.config import VseConfig as JaxConfig
from vse_tpu.core.subtitle_area import SubtitleArea as JaxArea
from vse_tpu.pipeline.extractor import SubtitleExtractor as JaxExtractor
from vse_tpu_torch.core.config import VseConfig
from vse_tpu_torch.core.subtitle_area import SubtitleArea
from vse_tpu_torch.pipeline.extractor import SubtitleExtractor

W, H, FPS, SEG = 320, 240, 25.0, 50
# one read per 2 s segment: a CJK line, a line that lost its CJK
# characters (what the debugger dumps), nothing, a mixed line
READS = ["你好世界", "ni hao", None, "你好 abc"]
AREA = (190, 239, 0, 319)


def write_clip(path):
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), FPS, (W, H))
    for seg, text in enumerate(READS):
        for _ in range(SEG):
            frame = np.full((H, W, 3), 40, np.uint8)
            if text is not None:  # a distinct stripe phase per segment
                frame[200:224, 20 + seg * 3 : 300 : 5] = 255
            vw.write(frame)
    vw.release()


class ScriptedCjkEngine:
    """A ch-family engine whose read is fixed per stripe phase, in both
    packages' engine contracts (``family``; ``spec.rec_family``)."""

    family = "ch"

    class spec:  # noqa: N801
        rec_family = "ch"

    def predict_batch(self, frames, origin=(0, 0)):
        dy, dx = origin
        out = []
        for f in np.asarray(frames):
            rows = np.nonzero((f > 128).any(axis=(1, 2)))[0]
            if len(rows) == 0:
                out.append(([], []))
                continue
            y0, y1 = int(rows.min()), int(rows.max()) + 1
            seg = max(0, (int(np.nonzero(f[y0, :, 0] > 128)[0][0]) - 20) // 3)
            quad = [(20 + dx, y0 + dy), (300 + dx, y0 + dy), (300 + dx, y1 + dy),
                    (20 + dx, y1 + dy)]
            out.append(([quad], [(READS[min(seg, len(READS) - 1)], 0.95)]))
        return out


def _run_both(tmp_path, with_area):
    """Run each package's extractor on its own copy of the clip (the loss
    dumps go beside the video); returns the two directories."""
    dirs = [tmp_path / "port", tmp_path / "jax"]
    for d in dirs:
        d.mkdir()
    write_clip(str(dirs[0] / "v.avi"))
    shutil.copy(dirs[0] / "v.avi", dirs[1] / "v.avi")
    kw = dict(language="ch", debug_ocr_loss=True, debug_no_delete_cache=True,
              word_segmentation=False)
    port = SubtitleExtractor(str(dirs[0] / "v.avi"), SubtitleArea(*AREA) if with_area else None,
                             VseConfig(**kw), engine=ScriptedCjkEngine(), device="cpu")
    jax = JaxExtractor(str(dirs[1] / "v.avi"), JaxArea(*AREA) if with_area else None,
                       JaxConfig(mode=JaxMode.FAST, **kw), engine=ScriptedCjkEngine())
    for ex in (port, jax):
        ex.append_output = lambda *a: None
        ex.run()
    return dirs, port, jax


@pytest.mark.parametrize("strategy", ["keyframe", "fps"])
def test_ocr_loss_dumps_and_raw_records_match_jax(tmp_path, strategy):
    """The same ``loss/`` files (names and pixels), the same ``raw.txt``
    and the same SRT as the JAX extractor."""
    dirs, port, jax = _run_both(tmp_path, strategy == "keyframe")
    names = [sorted(os.listdir(d / "loss")) for d in dirs]
    assert names[0] == names[1]
    assert names[0], "the debugger dumped nothing"
    # only the read that lost its CJK characters is dumped
    lost = {r.frame_no for r in jax.raw_records if r.text == "ni hao"}
    assert {int(n[:8]) for n in names[0]} == lost
    for n in names[0]:
        a = cv2.imread(str(dirs[0] / "loss" / n))
        b = cv2.imread(str(dirs[1] / "loss" / n))
        assert np.array_equal(a, b), n
    raws = [(d / "raw.txt").read_text(encoding="utf-8") for d in dirs]
    assert raws[0] == raws[1] and raws[0].count("\n") == len(jax.raw_records)
    srts = [(d / "v.srt").read_text(encoding="utf-8") for d in dirs]
    assert srts[0] == srts[1]


def test_debugger_is_off_by_default_and_watches_cjk_families(tmp_path):
    """No ``loss/`` without ``debug_ocr_loss``, and none for a family the
    debugger does not watch (the JAX package's four: ch, chinese_cht,
    japan, korean)."""
    path = str(tmp_path / "v.avi")
    write_clip(path)
    ex = SubtitleExtractor(path, SubtitleArea(*AREA), VseConfig(language="ch",
                           word_segmentation=False), engine=ScriptedCjkEngine(), device="cpu")
    ex.append_output = lambda *a: None
    ex.run()
    assert not os.path.exists(tmp_path / "loss")
    assert not os.path.exists(tmp_path / "raw.txt")

    class LatinEngine(ScriptedCjkEngine):
        family = "latin"

    ex = SubtitleExtractor(path, SubtitleArea(*AREA), VseConfig(
        language="fr", word_segmentation=False, debug_ocr_loss=True),
        engine=LatinEngine(), device="cpu")
    ex.append_output = lambda *a: None
    ex.run()
    assert not os.path.exists(tmp_path / "loss")
    assert SubtitleExtractor._LOSS_RE.pattern == JaxExtractor._LOSS_RE.pattern


def test_capture_frame_with_subtitle_area_matches_jax(tmp_path):
    path = str(tmp_path / "v.avi")
    write_clip(path)
    port = SubtitleExtractor(path, SubtitleArea(*AREA), VseConfig(language="ch"),
                             engine=ScriptedCjkEngine(), device="cpu")
    jax = JaxExtractor(path, JaxArea(*AREA), JaxConfig(language="ch"),
                       engine=ScriptedCjkEngine())
    got = port.capture_frame_with_subtitle_area(str(tmp_path / "port.jpg"))
    want = jax.capture_frame_with_subtitle_area(str(tmp_path / "jax.jpg"))
    assert np.array_equal(cv2.imread(got), cv2.imread(want))
    assert port.capture_frame_with_subtitle_area() == str(tmp_path / "sub_area.jpg")
