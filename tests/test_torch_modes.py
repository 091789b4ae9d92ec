"""Mode resolution and accurate mode's span tracker against the JAX
package's, on the CPU: ``core/registry.py::resolve`` for every language,
mode and accelerator flag; the models each mode's engine loads; and
``DetSpanTracker`` fed the same per-frame OCR results as the JAX tracker
(presence flips, dropouts inside the grace, fades that merge back, a run
longer than ``_FLUSH_AFTER``, set to 24 on both sides for the test), which
must give the same raw records and
the same SRT. Integer outputs, so everything is compared exactly."""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vse_tpu.core.config import Mode as JaxMode
from vse_tpu.core.config import VseConfig as JaxConfig
from vse_tpu.core.registry import resolve as jax_resolve
from vse_tpu.core.subtitle_area import SubtitleArea as JaxArea
from vse_tpu.pipeline.extractor import DetSpanTracker as JaxTracker
from vse_tpu.pipeline.extractor import SubtitleExtractor as JaxExtractor
from vse_tpu_torch import cli
from vse_tpu_torch.core.config import LANGUAGES, Mode, VseConfig
from vse_tpu_torch.core.registry import resolve
from vse_tpu_torch.core.subtitle_area import SubtitleArea
from vse_tpu_torch.models.db_detector import DBDetector
from vse_tpu_torch.models.ppocr_det import PPOCRv3DetMobile
from vse_tpu_torch.pipeline.extractor import DetSpanTracker, SubtitleExtractor
from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
from vse_tpu_torch.video.decode import InMemoryVideo

AREA = (150, 230, 10, 310)


@pytest.mark.parametrize("mode", ["fast", "auto", "accurate"])
@pytest.mark.parametrize("accelerated", [True, False])
def test_resolve_table_equals_jax(mode, accelerated):
    for lang in LANGUAGES:
        got = resolve(lang, Mode(mode), accelerated)
        want = jax_resolve(lang, JaxMode(mode), accelerated)
        assert (got.det_variant, got.rec_variant, got.rec_family) == (
            want.det_variant, want.rec_variant, want.rec_family), lang
        assert os.path.exists(got.det_ckpt)


def test_each_mode_loads_its_det_and_falls_back_to_the_mobile_rec():
    """Accurate runs the server det; auto the server det when accelerated,
    which defaults to a CUDA device, so on the CPU it runs the PP-OCRv3
    mobile det (fast mode's) unless asked. The rec is the mobile head in
    every mode (no server head is exported)."""
    kinds = {}
    for mode in ("accurate", "auto"):
        eng = OcrEngine("en", Mode(mode), VseConfig(language="en", mode=mode), device="cpu")
        kinds[mode] = (type(eng.det_model), eng.spec.rec_variant, eng.rec_variant)
    assert kinds["accurate"] == (DBDetector, "server", "mobile")
    assert kinds["auto"] == (PPOCRv3DetMobile, "mobile", "mobile")
    assert resolve("en", Mode.AUTO, True).det_variant == "server"
    with pytest.raises(ValueError, match="decode"):
        OcrEngine("en", device="cpu", decode="viterbi")


def test_cli_mode_choices_equal_the_jax_clis():
    import vse_tpu.cli as jax_cli

    src = open(jax_cli.__file__, encoding="utf-8").read()
    assert 'choices=["fast", "auto", "accurate"]' in src
    for mode in ("fast", "auto", "accurate"):
        assert cli.main(["extract", "/nonexistent.avi", "--mode", mode, "--device", "cpu"]) == 1
    with pytest.raises(SystemExit):
        cli.main(["extract", "/nonexistent.avi", "--mode", "turbo"])


class FakeEngine:
    """The engine surface the tracker reads, in both packages' contracts."""

    family = "en"

    class spec:  # noqa: N801
        rec_family = "en"


def quad(x0, x1, y0, y1):
    return [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]


FLUSH_AFTER = 24  # _FLUSH_AFTER for this test, so that a short run passes it


def script(n=160, seed=0):
    """Per-frame results: cues with garbled fade edges, 1-4 frame dropouts
    inside cues, a scene line outside the area, a low-score line, gaps of
    6+ frames between cues, and one cue of 60 frames (over
    ``FLUSH_AFTER``) whose text changes midway."""
    rng = np.random.default_rng(seed)
    cues = [(5, 40, "hello world"), (48, 70, "second line here"),
            (77, 137, "a long static overlay"), (143, 155, "last")]
    out = []
    for f in range(1, n + 1):
        dt_box, rec_res = [], []
        for a, b, text in cues:
            if a <= f <= b:
                if text.startswith("a long") and f > 110:
                    text = "the overlay changed"
                if f in (a, b):
                    text = text[::2]  # a garbled fade edge
                if a + 10 <= f <= a + 12 and rng.random() < 0.7:
                    break  # a dropout inside the grace
                dt_box.append(quad(20, 300, 170, 200))
                rec_res.append((text, float(rng.uniform(0.8, 0.99))))
        if f % 7 == 0:
            dt_box.append(quad(20, 120, 10, 40))  # outside the area
            rec_res.append(("scene", 0.95))
        if f % 11 == 0 and dt_box:
            dt_box.append(quad(200, 300, 205, 225))
            rec_res.append(("faint", 0.5))  # under the drop score
        out.append((f, dt_box, rec_res))
    return out


def test_tracker_gives_the_jax_trackers_records_and_srt(tmp_path, monkeypatch):
    assert DetSpanTracker._FLUSH_AFTER == JaxTracker._FLUSH_AFTER == 256
    for cls in (DetSpanTracker, JaxTracker):
        monkeypatch.setattr(cls, "_FLUSH_AFTER", FLUSH_AFTER)
    path = str(tmp_path / "v.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 25.0, (320, 240))
    for _ in range(4):
        vw.write(np.zeros((240, 320, 3), np.uint8))
    vw.release()
    port = SubtitleExtractor(InMemoryVideo(np.zeros((4, 240, 320, 3), np.uint8), 25.0, path),
                             SubtitleArea(*AREA), VseConfig(language="en", mode=Mode.ACCURATE),
                             engine=FakeEngine(), device="cpu")
    jax = JaxExtractor(path, JaxArea(*AREA), JaxConfig(language="en", mode=JaxMode.ACCURATE),
                       engine=FakeEngine())
    jax.fps = port.fps = 25.0
    trackers = [DetSpanTracker(port), JaxTracker(jax)]
    assert trackers[0].grace == trackers[1].grace == 5
    for frame_no, dt_box, rec_res in script():
        for t in trackers:
            t.feed(frame_no, dt_box, rec_res)
    for t in trackers:
        t.finish()
    got = [(r.frame_no, r.coord, r.text) for r in port.raw_records]
    want = [(r.frame_no, tuple(r.coord), r.text) for r in jax.raw_records]
    assert [(f, tuple(c), t) for f, c, t in got] == want
    assert len(want) >= 8 and "faint" not in {r[2] for r in want}
    port.subtitle_output_path = str(tmp_path / "port.srt")
    jax.subtitle_output_path = str(tmp_path / "jax.srt")
    port.generate_subtitle_file()
    jax.generate_subtitle_file()
    srts = [open(ex.subtitle_output_path, encoding="utf-8").read() for ex in (port, jax)]
    assert srts[0] == srts[1] and srts[0].count("-->") >= 4
    assert port._area_text(*script()[20][1:]) == jax._area_text(*script()[20][1:])
