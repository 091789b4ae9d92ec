"""The fps strategy (no subtitle area) end to end against the JAX package,
on the CPU, with the default config: word segmentation on, the watermark and
scene-text filters with their auto policy.

A 100-frame 1280x720 clip made from the committed no-area fixture (all three
cues, the corner watermark on every frame, the scene-text sign on a few) is
written losslessly (FFV1). At 25 fps and 3 samples a second the stride is
8: 13 sampled frames, two OCR batches of 8 full frames. The cues are short
(11 samples, 3 texts), so the auto watermark policy keeps them and the SRT
holds their reads. The SRTs must be byte-identical through the port's path
input, its in-memory input, a resumed run and its CLI (two videos,
``--txt``, ``--output``). Also: the port's OCR engine reads what the JAX
engine reads on full 720p frames (letterboxed into the 576 x 960 det
bucket), and a run can be cancelled and reports progress.
"""

import os
import shutil

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from vse_tpu.core.config import VseConfig as JaxConfig
from vse_tpu.pipeline.extractor import SubtitleExtractor as JaxExtractor
from vse_tpu.pipeline.resume import ProgressManifest as JaxManifest
from vse_tpu.post.records import RawRecord as JaxRecord
from vse_tpu.post.srt import srt_to_txt as jax_srt_to_txt
from vse_tpu_torch import cli
from vse_tpu_torch.core.config import VseConfig
from vse_tpu_torch.pipeline.extractor import ExtractionCancelled, SubtitleExtractor
from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
from vse_tpu_torch.video.decode import InMemoryVideo
from vse_tpu_torch.video.synth import compose_frames, load_fixture


def write_ffv1(frames, path):
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 25.0, (1280, 720))
    for f in frames:
        vw.write(np.ascontiguousarray(f[:, :, ::-1]))
    vw.release()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    bands, recipe = load_fixture(recipe="recipe_fps.json")
    cues = {c["band"]: c for c in recipe["cues"]}
    recipe = dict(recipe, n_frames=100, cues=[
        dict(cues["band0"], first=6, last=35),
        dict(cues["band1"], first=38, last=65),
        dict(cues["band2"], first=68, last=95),
        dict(cues["watermark"], first=1, last=100),
        dict(cues["scene"], first=57, last=74),
    ])
    frames = compose_frames(bands, recipe)
    path = str(tmp_path_factory.mktemp("fps") / "clip.avi")
    write_ffv1(frames, path)
    return path, frames


@pytest.fixture(scope="module")
def jax_run(clip):
    path, _ = clip
    ex = JaxExtractor(path, None, JaxConfig(language="en"))
    with open(ex.run(), encoding="utf-8") as f:
        return f.read(), ex


@pytest.fixture(scope="module")
def engine():
    return OcrEngine(language="en", device="cpu")


def port_run(video, engine, out, **kw):
    ex = SubtitleExtractor(video, None, VseConfig(language="en"), engine=engine,
                           device="cpu", **kw)
    ex.subtitle_output_path = out
    with open(ex.run(), encoding="utf-8") as f:
        return f.read(), ex


def test_fps_srt_byte_identical_to_jax(clip, jax_run, engine, tmp_path):
    path, frames = clip
    ref, jex = jax_run
    assert ref.count("-->") >= 3 and "the last cue of the clip" in ref
    got, ex = port_run(path, engine, str(tmp_path / "port.srt"))
    assert got == ref
    assert [(r.frame_no, tuple(r.coord), r.text) for r in ex.raw_records] == \
        [(r.frame_no, tuple(r.coord), r.text) for r in jex.raw_records]
    assert ex.n_samples == 13 and ex.n_spans == 0
    mem = InMemoryVideo(frames, 25.0, str(tmp_path / "mem.avi"))
    assert port_run(mem, engine, str(tmp_path / "mem.srt"))[0] == ref


def test_engine_reads_full_frames_as_the_jax_engine(clip, jax_run, engine):
    """Full 1280x720 frames letterbox into the 576 x 960 det bucket. Same
    texts and line boxes (exact: the port emulates the JAX engine's bf16
    numerics); scores within 0.02 (the f32 sums of the convolutions and the
    LSTM's transcendentals differ in order and in the last bits, which flips
    a bf16 rounding now and then)."""
    _, frames = clip
    assert engine.det_bucket(720, 1280) == (576, 960)
    batch = frames[[0, 8, 16, 56, 64, 72, 80, 96]]
    got = engine.predict_batch(batch)
    ref = jax_run[1].engine.predict_batch(batch)
    assert sum(len(b) for b, _ in got) >= 8
    for (g_box, g_res), (r_box, r_res) in zip(got, ref):
        assert [t for t, _ in g_res] == [t for t, _ in r_res]
        np.testing.assert_allclose([p for _, p in g_res], [p for _, p in r_res], atol=0.02)
        assert g_box == r_box
    as_tensor = engine.predict_batch(torch.from_numpy(batch))
    assert as_tensor == got


def test_resumed_run_matches_a_resumed_jax_run(clip, jax_run, engine, tmp_path):
    """A manifest written by the JAX package (the records of frames 1-49 of
    the full run) resumes both packages from frame 49; the port clears it."""
    path, _ = clip
    _, jex = jax_run
    recs = [r for r in jex.raw_records if r.frame_no <= 49]
    video = str(tmp_path / "resume.avi")
    shutil.copyfile(path, video)

    def manifest():
        JaxManifest(video, "fps", 49, [JaxRecord(r.frame_no, r.coord, r.text) for r in recs]).save()

    manifest()
    want = JaxExtractor(video, None, JaxConfig(language="en"), resume=True)
    want.subtitle_output_path = str(tmp_path / "jax.srt")
    with open(want.run(), encoding="utf-8") as f:
        ref = f.read()
    manifest()
    got, ex = port_run(video, engine, str(tmp_path / "port.srt"), resume=True)
    assert got == ref and ex.n_samples == 7  # frames 50, 58, ..., 98
    assert not os.path.exists(JaxManifest.path_for(video))


def test_cancel_and_progress(clip, engine, tmp_path):
    path, _ = clip
    ex = SubtitleExtractor(path, None, VseConfig(language="en"), engine=engine, device="cpu")
    ex.subtitle_output_path = str(tmp_path / "c.srt")
    seen = []
    ex.add_progress_listener(lambda a, b: seen.append((a, b)))
    ex.cancel.set()
    with pytest.raises(ExtractionCancelled):
        ex.run()
    assert seen == [(0, 0)] and not os.path.exists(ex.subtitle_output_path)


def test_cli_two_videos_no_area_txt_and_output(clip, jax_run, tmp_path):
    path, _ = clip
    ref = jax_run[0]
    second = str(tmp_path / "second.avi")
    shutil.copyfile(path, second)
    out = tmp_path / "out"
    rc = cli.main(["extract", path, second, "--language", "en", "--txt",
                   "--output", str(out), "--device", "cpu"])
    assert rc == 0
    jax_srt = tmp_path / "jax.srt"
    jax_srt.write_text(ref, encoding="utf-8")
    with open(jax_srt_to_txt(str(jax_srt)), encoding="utf-8") as f:
        txt = f.read()
    for stem in ("clip", "second"):
        assert (out / f"{stem}.srt").read_text(encoding="utf-8") == ref
        assert (out / f"{stem}.txt").read_text(encoding="utf-8") == txt
    rc = cli.main(["extract", str(tmp_path / "missing.avi"), "--device", "cpu"])
    assert rc == 1
