"""The fps strategy for ch, the default language, end to end against the
JAX package, on the CPU, with the default config (no area: the watermark and
scene-text filters with their auto policy, word segmentation).

The 20 s 1280x720 clip of ``assets/smoke/recipe_ch_fps_short.json`` (three
CJK cues of 56 frames, the committed corner watermark and scene-text sign)
is sampled every 8th frame: 63 full frames, letterboxed into the 576 x 960
det bucket. Through the port's extractor (in memory, OCR chunks of 2
frames to keep the 21,060-class logits small; see ``tests/test_torch_ch.py``)
every OCR line before the filters must equal the JAX package's record
(``reference_ch_fps_short_raw.json``: frame, box and text, all exact, the
score within ``SCORE_ATOL``), and
the SRT must be byte-identical to ``reference_ch_fps_short.srt``; through
the port's CLI with no flag (the clip written losslessly as FFV1; the
config it builds gets ``max_batch_size=2`` too, by ``small_chunks``) the SRT
must be the same.
"""

import json
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from _torch_helpers import small_chunks, two_threads  # noqa: F401
from vse_tpu_torch import cli
from vse_tpu_torch.core.config import VseConfig
from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
from vse_tpu_torch.video.synth import SMOKE_FIXTURE, compose_clip, compose_frames, load_fixture

# a line's score against the JAX package's: 0.07 while the crops' ``48 / bh``
# was a reciprocal multiply (ROADMAP fault 10: the static watermark's garbage
# read was 0.0546 off); the emulated models' last bits leave 0.0038
SCORE_ATOL = 0.005


def fixture_file(name):
    with open(os.path.join(SMOKE_FIXTURE, name), encoding="utf-8") as f:
        return f.read()


@pytest.fixture(scope="module")
def reference():
    return fixture_file("reference_ch_fps_short.srt")


def test_fps_lines_and_srt_byte_identical_to_jax(reference, tmp_path):
    raw_ref = json.loads(fixture_file("reference_ch_fps_short_raw.json"))
    assert reference.count("-->") == 3 and "你好世界" in reference
    bands, recipe = load_fixture(recipe="recipe_ch_fps_short.json")
    ex = SubtitleExtractor(compose_clip(bands, recipe, str(tmp_path / "ch.avi")), None,
                           VseConfig(max_batch_size=2), device="cpu")
    seen = {}
    scores = []
    filt, gate = ex.apply_filters, ex._gate_lines

    def keep_then_filter():  # the records as they reach the filters
        seen["raw"] = [[r.frame_no, list(r.coord), r.text] for r in ex.raw_records]
        filt()

    def keep_scores(*args):  # each kept line's score, in record order
        kept = gate(*args)
        scores.extend(prob for _, _, prob in kept)
        return kept

    ex.apply_filters, ex._gate_lines = keep_then_filter, keep_scores
    with open(ex.run(), encoding="utf-8") as f:
        assert f.read() == reference
    assert ex.n_samples == 63
    assert seen["raw"] == [r[:3] for r in raw_ref]
    np.testing.assert_allclose(scores, [r[3] for r in raw_ref], rtol=0, atol=SCORE_ATOL)


def test_cli_with_no_flag_runs_ch(reference, small_chunks, tmp_path):
    bands, recipe = load_fixture(recipe="recipe_ch_fps_short.json")
    path = str(tmp_path / "ch.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 25.0, (1280, 720))
    for f in compose_frames(bands, recipe):
        vw.write(np.ascontiguousarray(f[:, :, ::-1]))
    vw.release()
    assert cli.main(["extract", path, "--device", "cpu"]) == 0
    with open(str(tmp_path / "ch.srt"), encoding="utf-8") as f:
        assert f.read() == reference
