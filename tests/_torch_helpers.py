"""Fixtures shared by the port's torch-heavy CPU test files.

Import them into a test module by name (pytest finds fixtures among a
module's names, autouse ones included):

    from _torch_helpers import small_chunks, two_threads  # noqa: F401
"""

from __future__ import annotations

import pytest
import torch

from vse_tpu_torch.core import config as config_module
from vse_tpu_torch.core.config import VseConfig


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads while the importing file runs: the tier-1 run
    puts six test workers on one machine, and the bf16 emulation's thousands
    of small ops a chunk stall when every worker's thread pool wants every
    core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_chunks(monkeypatch):
    """The CLI's ``VseConfig`` with OCR chunks of 2 frames (the CLI has no
    flag for it): 16 crops of 21,060-class logits at a time, not 64."""
    class SmallChunks(VseConfig):
        def __init__(self, **kw):
            super().__init__(**{"max_batch_size": 2, **kw})

    monkeypatch.setattr(config_module, "VseConfig", SmallChunks)


# a keyframe OCR line's score against the JAX package's record: the models
# emulate the JAX engine's bf16 numerics but for f32 sum order and the last
# bits of exp / tanh, which move a mean of softmax maxima by under 0.005
SCORE_ATOL = 0.005
# ROADMAP fault 11: the det's convolutions sum in another order than XLA's
# (PyTorch's CPU kernels here, cuDNN on the card), which moves a det box by
# up to 2 px at the families' band shape, or leaves it equal as an integer
# but not as a float. A moved crop moves the line's score, and on marginal
# glyphs its read. What the port reads otherwise than the JAX package, on
# the CPU or on the card, is listed here (the JAX read stays acceptable):
# the cue's index in the SRT and the port's read, and a line's text.
FAULT_11 = {
    # latin's lines: boxes equal as integers, crops 1/8-1/4 px apart;
    # scores 0.0226 (CPU) and 0.0266 (card) off
    "latin": {"score_atol": 0.03},
    # te's second cue: a 22 px fragment right of it reads 'ష' on both sides;
    # its box is 1 px wider in the port, which scores it 0.836 against
    # 0.323, over the area gate's 0.75, so the cue gains " ష"; the cue's own
    # lines keep their boxes as integers, scores 0.0096 off (CPU)
    "te": {"cues": {2: "ధన్యఙాద ష"}, "score_atol": 0.012},
    # th's second cue on the CPU: its box 1-2 px off, ุ read as ู
    "th": {"cues": {2: "ขอบคูณ"}, "texts": {"ขอบคุณ": "ขอบคูณ"}},
}


def srt_matches(got, want, family):
    """The port's SRT equals the JAX reference, or the reference with the
    family's fault-11 cues read as the port reads them."""
    if got == want:
        return True
    cues = want.split("\n\n")
    for i, text in FAULT_11.get(family, {}).get("cues", {}).items():
        cues[i - 1] = "\n".join(cues[i - 1].split("\n")[:2] + [text])
    return got == "\n\n".join(cues)


def line_mismatches(got, want, family):
    """(port, JAX) line pairs that differ beyond fault 11: the frame, the
    text (or its fault-11 read), a box by more than 2 px, or, where the box
    is equal, a score by more than ``SCORE_ATOL`` (the family's own where
    fault 11 gives one)."""
    f11 = FAULT_11.get(family, {})
    atol = f11.get("score_atol", SCORE_ATOL)
    bad = [(g, w) for g, w in zip(got, want)
           if g[0] != w[0] or g[2] not in (w[2], f11.get("texts", {}).get(w[2]))
           or max(abs(a - b) for a, b in zip(g[1], w[1])) > 2
           or (g[1] == w[1] and abs(g[3] - w[3]) > atol)]
    if len(got) != len(want):
        bad.append((len(got), len(want)))
    return bad


def script_family_keyframe(family, tmp_path):
    """A non-CJK family's keyframe clip (``recipe_scripts.json``) through
    ``SubtitleExtractor(..., device="cpu")`` with the default config for its
    language: the SRT must equal the JAX CLI's byte for byte, and every OCR
    line of every keyframe sample the JAX extractor's record (frame and
    text exact, a box within 2 px, a score within ``SCORE_ATOL``), but for
    what ``FAULT_11`` lists. Returns the extractor."""
    from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
    from vse_tpu_torch.video.synth import (
        compose_clip, load_script_fixture, load_script_reference, recipe_area,
    )

    bands, recipe = load_script_fixture(family)
    ref = load_script_reference(family)
    clip = compose_clip(bands, recipe, str(tmp_path / f"{family}.avi"))
    ex = SubtitleExtractor(clip, recipe_area(recipe), VseConfig(language=ref["language"]),
                           device="cpu")
    assert ex.engine.family == family
    lines = []
    refine = ex.refine_keyframe_spans

    def keep_lines(spans, samples):  # samples: [(span, frame_no, dt_box, rec_res)]
        lines.extend([s[1], [q[0][0], q[1][0], q[0][1], q[2][1]], t, p]
                     for s in samples for q, (t, p) in zip(s[2], s[3]))
        return refine(spans, samples)

    ex.refine_keyframe_spans = keep_lines
    with open(ex.run(), encoding="utf-8") as f:
        got = f.read()
    assert srt_matches(got, ref["srt"], family), f"{got}\n--- want\n{ref['srt']}"
    # the JAX scan misses ta's shortest cue (ROADMAP fault 8): its SRT holds
    # two cues, and the port's must equal it
    assert ref["srt"].count("-->") == (2 if family == "ta" else 3)
    assert not line_mismatches(lines, ref["lines"], family)
    return ex


def script_family_cli(family, tmp_path):
    """A non-CJK family's keyframe clip, written losslessly (FFV1), through
    ``cli extract --area A --language CODE --device cpu``: the SRT must
    equal the JAX CLI's byte for byte (but for ``FAULT_11``)."""
    import cv2
    import numpy as np

    from vse_tpu_torch import cli
    from vse_tpu_torch.video.synth import (
        compose_frames, load_script_fixture, load_script_reference,
    )

    bands, recipe = load_script_fixture(family)
    ref = load_script_reference(family)
    path = str(tmp_path / f"{family}.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 25.0, (1280, 720))
    for f in compose_frames(bands, recipe):
        vw.write(np.ascontiguousarray(f[:, :, ::-1]))
    vw.release()
    area = ",".join(str(v) for v in recipe["area"])
    assert cli.main(["extract", path, "--area", area, "--language", ref["language"],
                     "--device", "cpu"]) == 0
    with open(str(tmp_path / f"{family}.srt"), encoding="utf-8") as f:
        assert srt_matches(f.read(), ref["srt"], family)
