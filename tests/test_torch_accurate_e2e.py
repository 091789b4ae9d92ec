"""Modes accurate and auto end to end on the CPU, with the real server det
(``det_server``, ResNet-50 and FPN 256) and the en rec head, against the
JAX package's references committed in ``assets/smoke/reference_accurate.json``
(``tools/make_torch_smoke_fixture.py --accurate``: the JAX engine given the
server det's weights, ROADMAP fault 15).

- The small accurate clip (``small``: 24 frames of 256 x 64, the sign and
  the watermark as two cues, two boxes a frame): ``SubtitleExtractor`` in mode accurate with
  an area, the per-frame detection path. Its SRT must equal the JAX SRT
  byte for byte and its raw records the JAX records exactly; every OCR line
  that the tracker was fed must equal the JAX line's frame and text, its
  box within 2 px and, where the box is equal, its score within
  ``SCORE_ATOL``.
- ``extract_many`` on two clips and a service task in mode accurate with
  an area, through both packages with the same scripted OCR (the engine is
  the one part neither runs itself): the same SRTs.
- ``OcrEngine(mode="accurate", decode="beam")`` on 2 of the 8 band frames
  of the keyframe clip (cue 1, cue 2; ``chip_smoke.py`` runs all 8): each
  line's beam ids and text equal the JAX beam's,
  its box within 2 px and its score within ``FAULT_11["beam"]``'s 0.003
  where the box is equal (the rec's sums, ROADMAP fault 11).
"""

import json
import os

import numpy as np
import pytest

from _torch_helpers import jax_full_batches, line_mismatches, two_threads  # noqa: F401
from vse_tpu_torch.core.config import Mode, VseConfig
from vse_tpu_torch.core.subtitle_area import SubtitleArea
from vse_tpu_torch.pipeline import extractor as port_extractor
from vse_tpu_torch.pipeline import ocr_engine
from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
from vse_tpu_torch.pipeline.multistream import extract_many
from vse_tpu_torch.pipeline.service import ExtractionService
from vse_tpu_torch.video.decode import InMemoryVideo
from vse_tpu_torch.video.synth import SMOKE_FIXTURE, compose_frames, load_fixture

with open(os.path.join(SMOKE_FIXTURE, "reference_accurate.json"), encoding="utf-8") as f:
    REFS = json.load(f)
SMALL = REFS["small"]
CFG = VseConfig(language="en", mode=Mode.ACCURATE)
SMALL_CFG = VseConfig(language="en", mode=Mode.ACCURATE, **SMALL["config"])


def box_of(q):
    return [q[0][0], q[1][0], q[0][1], q[2][1]]


@pytest.fixture(scope="module")
def engine():
    return ocr_engine.OcrEngine("en", Mode.ACCURATE, SMALL_CFG, device="cpu")


@pytest.fixture(scope="module")
def small_frames():
    bands = load_fixture(recipe="recipe_fps.json")[0]
    return compose_frames(bands, SMALL["recipe"])


def test_small_clip_per_frame_detection_equals_jax(engine, small_frames, tmp_path, monkeypatch):
    lines = []
    feed = port_extractor.DetSpanTracker.feed

    def keep(self, frame_no, dt_box, rec_res):
        lines.extend([frame_no, box_of(q), t, p] for q, (t, p) in zip(dt_box, rec_res))
        return feed(self, frame_no, dt_box, rec_res)

    monkeypatch.setattr(port_extractor.DetSpanTracker, "feed", keep)
    clip = InMemoryVideo(small_frames, 25.0, str(tmp_path / "small.avi"))
    ex = SubtitleExtractor(clip, SubtitleArea(*SMALL["recipe"]["area"]), SMALL_CFG,
                           engine=engine, device="cpu")
    with open(ex.run(), encoding="utf-8") as f:
        assert f.read() == SMALL["srt"]
    assert ex.n_samples == SMALL["recipe"]["n_frames"] and not ex.use_keyframe_timeline
    assert [[r.frame_no, list(r.coord), r.text] for r in ex.raw_records] == SMALL["raw"]
    assert not line_mismatches(lines, SMALL["lines"], "en")
    assert SMALL["srt"].count("-->") == 2


class ScriptedEngine:
    """Reads a frame's stripe phase as text, in both packages' contracts."""

    family = "en"
    device = "cpu"  # where the port's batch surface uploads frames

    class spec:  # noqa: N801
        rec_family = "en"

    def predict_batch(self, frames, origin=(0, 0)):
        dy, dx = origin
        out = []
        for f in np.asarray(frames):
            on = f[:, :, 0] > 128
            if not on.any():
                out.append(([], []))
                continue
            ys, xs = np.nonzero(on)
            x0, x1, y0, y1 = int(xs.min()), int(xs.max()), int(ys.min()) + dy, int(ys.max()) + dy
            text = "first cue here" if x0 < 22 else "the second one"
            out.append(([[(x0, y0), (x1, y0), (x1, y1), (x0, y1)]], [(text, 0.95)]))
        return out


def stripes_clip(path):
    """60 frames of 160 x 96: two stripe phases (two reads of the scripted
    engine) for 20 frames each, 10 frames apart."""
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 25.0, (160, 96))
    for i in range(60):
        f = np.full((96, 160, 3), 30, np.uint8)
        if 5 <= i < 25 or 35 <= i < 55:
            f[60:80, 20 + 3 * (i >= 35) : 140 : 4] = 255
        vw.write(f)
    vw.release()
    return path


def test_extract_many_and_a_service_task_in_accurate_mode(tmp_path):
    """The batch surface in mode accurate with an area, through both
    packages with the same scripted OCR (the engine is the part neither
    runs itself): ``extract_many`` on two clips (per-frame batches shared
    across the videos, one tracker a video) and one service task, the same
    SRTs."""
    from vse_tpu.core.config import VseConfig as JaxConfig
    from vse_tpu.core.subtitle_area import SubtitleArea as JaxArea
    from vse_tpu.pipeline.multistream import extract_many as jax_extract_many
    from vse_tpu.pipeline.service import ExtractionService as JaxService

    clips = [stripes_clip(str(tmp_path / "a.avi")), stripes_clip(str(tmp_path / "b.avi"))]
    jax_cfg = JaxConfig(language="en", mode="accurate")
    srts = {}
    for side in ("port", "jax"):
        outs = [str(tmp_path / f"{side}_{i}.srt") for i in range(2)]
        if side == "port":
            stats = {}
            extract_many(clips, [SubtitleArea(50, 90, 0, 160)] * 2, CFG, engine=ScriptedEngine(),
                         output_paths=outs, device="cpu", stats=stats)
            assert stats == {"chunks": 15, "samples": [60, 60]}  # 120 frames, 8 a batch
            svc = ExtractionService(CFG, device="cpu")
            area = SubtitleArea(50, 90, 0, 160)
        else:
            with jax_full_batches():
                jax_extract_many(clips, [JaxArea(50, 90, 0, 160)] * 2, jax_cfg,
                                 engine=ScriptedEngine(), output_paths=outs)
            svc = JaxService(jax_cfg)
            area = JaxArea(50, 90, 0, 160)
        svc._engine = ScriptedEngine()
        task = svc.add_task(clips[0], area, output_path=str(tmp_path / f"{side}_svc.srt"))
        svc.run_all()
        assert task.status.value == "completed", task.error
        srts[side] = [open(p, encoding="utf-8").read() for p in outs + [task.srt_path]]
    assert srts["port"] == srts["jax"]
    assert all(srt.count("-->") == 2 for srt in srts["port"])


BEAM_PICK = (1, 4)  # of the beam reference's frames: cue 1, cue 2


def test_beam_decode_equals_the_jax_beam(engine, monkeypatch):
    ref = REFS["beam"]
    bands, recipe = load_fixture()
    frames = compose_frames(bands, recipe, n_frames=max(ref["frames"]) + 1)
    y0, y1 = ref["band"]
    records = [ref["records"][i] for i in BEAM_PICK]
    first = np.cumsum([0] + [len(r) for r in ref["records"]])
    want_ids = [ref["ids"][j] for i in BEAM_PICK for j in range(first[i], first[i + 1])]
    ids = []
    beam = ocr_engine.ctc_prefix_beam_decode

    def keep_ids(*a, **kw):
        out = beam(*a, **kw)
        ids.append([int(i) for i in out[0]])
        return out

    monkeypatch.setattr(ocr_engine, "ctc_prefix_beam_decode", keep_ids)
    # the small clip's engine (its models already loaded) with beam decode;
    # its two boxes a frame hold the band's one line
    monkeypatch.setattr(engine, "decode", "beam")
    eng = engine
    picked = [ref["frames"][i] for i in BEAM_PICK]
    res = eng.predict_batch(np.ascontiguousarray(frames[picked, y0:y1]), origin=(y0, 0))
    assert ids == want_ids and len(ids) == 2
    got = [[[box_of(q), t, p] for q, (t, p) in zip(d, r)] for d, r in res]
    assert [len(g) for g in got] == [len(w) for w in records]
    flat = lambda recs: [[i, *line] for i, r in enumerate(recs) for line in r]  # noqa: E731
    assert not line_mismatches(flat(got), flat(records), "beam")
