"""The keyframe strategy for ch, the default language, end to end against
the JAX package, on the CPU, with the default config.

The 20 s 1280x720 clip of ``assets/smoke/recipe_ch.json`` (three CJK cues
drawn with the JAX package's stroke composer, a subtitle area around them)
goes through the port's extractor (in memory, OCR chunks of 2 frames to
keep the 21,060-class logits small; see ``tests/test_torch_ch.py``) and
through its CLI with no flag but the area (written losslessly as FFV1; the
config the CLI builds gets ``max_batch_size=2`` too, by ``small_chunks``).
Both SRTs must be byte-identical to ``reference_ch.srt``, which the JAX
package's CLI wrote for the same frames (``tools/make_torch_smoke_fixture.py
--language ch``), its misread of the first cue included.
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from _torch_helpers import small_chunks, two_threads  # noqa: F401
from vse_tpu_torch import cli
from vse_tpu_torch.core.config import VseConfig
from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
from vse_tpu_torch.video.synth import (
    SMOKE_FIXTURE, compose_clip, compose_frames, load_fixture, recipe_area,
)


def write_ffv1(frames, path):
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 25.0, (1280, 720))
    for f in frames:
        vw.write(np.ascontiguousarray(f[:, :, ::-1]))
    vw.release()


@pytest.fixture(scope="module")
def reference():
    with open(os.path.join(SMOKE_FIXTURE, "reference_ch.srt"), encoding="utf-8") as f:
        return f.read()


def test_reference_holds_the_three_cues(reference):
    assert reference.count("-->") == 3
    assert "我们明天见" in reference and "你好世界" in reference


def test_keyframe_srt_byte_identical_to_jax(reference, tmp_path):
    bands, recipe = load_fixture(recipe="recipe_ch.json")
    clip = compose_clip(bands, recipe, str(tmp_path / "ch.avi"))
    cfg = VseConfig(max_batch_size=2)
    assert cfg.language == "ch" and cfg.word_segmentation
    ex = SubtitleExtractor(clip, recipe_area(recipe), cfg, device="cpu")
    assert ex.engine.family == "ch"
    with open(ex.run(), encoding="utf-8") as f:
        assert f.read() == reference
    assert ex.n_spans == 3


def test_cli_with_an_area_and_no_other_flag_runs_ch(reference, small_chunks, tmp_path):
    bands, recipe = load_fixture(recipe="recipe_ch.json")
    path = str(tmp_path / "ch.avi")
    write_ffv1(compose_frames(bands, recipe), path)
    area = ",".join(str(v) for v in recipe["area"])
    assert cli.main(["extract", path, "--area", area, "--device", "cpu"]) == 0
    with open(str(tmp_path / "ch.srt"), encoding="utf-8") as f:
        assert f.read() == reference
