"""The keyframe strategy (a subtitle area, mode fast) with word segmentation
on — the default config — end to end against the JAX package, on the CPU.

The 84-frame 1280x720 clip of ``tests/test_torch_e2e.py`` (two cues of the
committed smoke fixture) is written losslessly (FFV1). The en head has no
space class, so the raw reads are glued ("hellofromthenewport..."); word
segmentation restores the spaces. The SRT must be byte-identical to the JAX
package's, through the port's extractor and its CLI (no flag but the area
and the language: the CLI's default language is the config's, ch).
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vse_tpu.core.config import VseConfig as JaxConfig
from vse_tpu.core.subtitle_area import SubtitleArea as JaxArea
from vse_tpu.pipeline.extractor import SubtitleExtractor as JaxExtractor
from vse_tpu_torch import cli
from vse_tpu_torch.core.config import VseConfig
from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
from vse_tpu_torch.video.synth import compose_frames, load_fixture, recipe_area


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    bands, recipe = load_fixture()
    recipe = dict(recipe, n_frames=84, cues=[
        dict(recipe["cues"][0], first=6, last=37),
        dict(recipe["cues"][1], first=46, last=77),
    ])
    frames = compose_frames(bands, recipe)
    path = str(tmp_path_factory.mktemp("ws") / "clip.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 25.0, (1280, 720))
    for f in frames:
        vw.write(np.ascontiguousarray(f[:, :, ::-1]))
    vw.release()
    return path, recipe


@pytest.fixture(scope="module")
def jax_srt(clip):
    path, recipe = clip
    ex = JaxExtractor(path, JaxArea(*recipe["area"]), JaxConfig(language="en"))
    ex.subtitle_output_path = path[: -len(".avi")] + ".jax.srt"
    with open(ex.run(), encoding="utf-8") as f:
        return f.read()


def test_keyframe_srt_with_word_segmentation_byte_identical(clip, jax_srt, tmp_path):
    path, recipe = clip
    assert "hello from the new port on the card" in jax_srt
    assert jax_srt.count("-->") == 2
    ex = SubtitleExtractor(path, recipe_area(recipe), VseConfig(language="en"), device="cpu")
    assert ex.config.word_segmentation
    ex.subtitle_output_path = str(tmp_path / "port.srt")
    with open(ex.run(), encoding="utf-8") as f:
        assert f.read() == jax_srt
    assert ex.n_spans == 2


def test_cli_with_an_area_and_no_other_flag(clip, jax_srt):
    path, recipe = clip
    area = ",".join(str(v) for v in recipe["area"])
    assert cli.main(["extract", path, "--area", area, "--language", "en", "--device", "cpu"]) == 0
    with open(path[: -len(".avi")] + ".srt", encoding="utf-8") as f:
        assert f.read() == jax_srt
    assert not os.path.exists(path[: -len(".avi")] + ".txt")
