"""The frame path with the crop in the stream's reader
(``FrameStream(..., region=...)``) against the JAX package, on the CPU, on
a lossless OpenCV file and on an ``InMemoryVideo`` of the same frames:

- mode fast (the keyframe scan): the scan's stats are K2's on the area of
  every frame in full batches of 32, exactly, and the JAX extractor's
  within rtol 1e-5 / atol 1e-6 (f32 sums in another order, as in
  ``tests/test_torch_kernels.py``); its frame numbers and spans equal the
  JAX extractor's; every chunk of the keyframe OCR pass is the stack of
  its samples' upload band; the raw records and the SRT equal the JAX
  extractor's;
- mode accurate (per-frame detection): every batch the engine gets is the
  frames' upload band at full width, and the raw records and the SRT equal
  the JAX extractor's;
- recording, the reader's counters ``decode.copy_bytes`` /
  ``decode.frame_bytes`` read the area's share of a frame (the scan) and
  the band's (per frame; none of an in-memory clip, whose full-width band
  is a contiguous view handed on uncopied).

A scripted engine stands in for the models on both sides, as in
``tests/test_torch_decode_ffmpeg.py``. Everything else is compared exactly.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from _torch_helpers import jax_full_batches
from vse_tpu.core.config import VseConfig as JaxConfig
from vse_tpu.core.subtitle_area import SubtitleArea as JaxArea
from vse_tpu.pipeline import extractor as jax_extractor
from vse_tpu_torch.core.config import VseConfig
from vse_tpu_torch.core.subtitle_area import SubtitleArea
from vse_tpu_torch.kernels.keyframe import ScanParams, scan_stats_u8
from vse_tpu_torch.pipeline import extractor
from vse_tpu_torch.utils import tracing
from vse_tpu_torch.video.decode import InMemoryVideo

FPS, N, H, W = 25.0, 90, 288, 160
AREA = (151, 181, 13, 147)  # ymin, ymax, xmin, xmax: odd offsets
BAND = (101, 231)  # the area and the default 50-pixel margin, full width


def make_frames():
    """Two cues of stripes in the area, on a background that changes every
    frame, with the channels apart so that a flip would show."""
    frames = np.empty((N, H, W, 3), np.uint8)
    ramp = np.arange(H, dtype=np.int64)[:, None] + np.arange(W)[None, :]
    for i in range(N):
        frames[i, :, :, 0] = (ramp + 3 * i) % 97
        frames[i, :, :, 1] = (ramp * 2 + i) % 113
        frames[i, :, :, 2] = 40
        if 10 <= i < 40 or 55 <= i < 85:
            frames[i, 160:175, 20 + 3 * (i >= 55) : 140 : 4] = (250, 90, 10)
    return frames


class ScriptedEngine:
    """Reads the stripes of a frame (channel 0 over 128) as one line, in
    both packages' engine contracts, and keeps every batch it was given."""

    family = "en"

    class spec:  # noqa: N801
        rec_family = "en"

    def __init__(self):
        self.batches = []

    def predict_batch(self, frames, origin=(0, 0)):
        frames = np.array(frames)
        self.batches.append((frames, tuple(origin)))
        out = []
        for f in frames:
            on = f[:, :, 0] > 128
            if not on.any():
                out.append(([], []))
                continue
            ys, xs = np.nonzero(on)
            dy, dx = origin
            x0, x1, y0, y1 = int(xs.min()) + dx, int(xs.max()) + dx, int(ys.min()) + dy, int(ys.max()) + dy
            text = "alpha beta" if xs.min() + dx < 22 else "gamma delta"
            out.append(([[(x0, y0), (x1, y0), (x1, y1), (x0, y1)]], [(text, 0.95)]))
        return out


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    frames = make_frames()
    path = str(tmp_path_factory.mktemp("band") / "band.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), FPS, (W, H))
    for f in frames:
        vw.write(np.ascontiguousarray(f[:, :, ::-1]))
    vw.release()
    return path, frames


def keep_scans(module, into):
    """``find_spans`` of ``module`` that keeps (stats, frame numbers, spans)."""
    find = module.find_spans

    def keep(stats, nos, *a, **kw):
        spans = find(stats, nos, *a, **kw)
        into.append((np.array(stats), np.array(nos), [(s.start_frame, s.end_frame) for s in spans]))
        return spans

    return keep


def records(ex):
    return [(r.frame_no, tuple(r.coord), r.text) for r in ex.raw_records]


@pytest.fixture(scope="module", params=["fast", "accurate"])
def jax_run(request, clip, tmp_path_factory):
    """The JAX extractor on the file: (mode, scans, records, SRT)."""
    path, _ = clip
    mode = request.param
    scans = []
    with pytest.MonkeyPatch.context() as mp, jax_full_batches():
        mp.setattr(jax_extractor, "find_spans", keep_scans(jax_extractor, scans))
        ex = jax_extractor.SubtitleExtractor(
            path, JaxArea(*AREA), JaxConfig(word_segmentation=False, mode=mode),
            engine=ScriptedEngine())
        ex.subtitle_output_path = str(tmp_path_factory.mktemp("jax") / "band.srt")
        ex.append_output = lambda *a: None
        with open(ex.run(), encoding="utf-8") as f:
            srt = f.read()
    assert srt.count("-->") == 2
    return mode, scans, records(ex), srt


@pytest.mark.parametrize("source", ["opencv", "memory"])
def test_band_crop_extracts_as_the_jax_package(jax_run, clip, source, tmp_path, monkeypatch):
    mode, jax_scans, jax_records, jax_srt = jax_run
    path, frames = clip
    video = path if source == "opencv" else InMemoryVideo(frames, FPS, str(tmp_path / "band.avi"))
    scans, targets = [], []
    monkeypatch.setattr(extractor, "find_spans", keep_scans(extractor, scans))
    engine = ScriptedEngine()
    ex = extractor.SubtitleExtractor(video, SubtitleArea(*AREA),
                                     VseConfig(word_segmentation=False, mode=mode),
                                     engine=engine, device="cpu")
    ex.subtitle_output_path = str(tmp_path / "port.srt")
    ex.append_output = lambda *a: None
    sample_targets = ex.keyframe_sample_targets

    def keep_targets(spans):
        wanted, metas = sample_targets(spans)
        targets.extend(wanted)
        return wanted, metas

    ex.keyframe_sample_targets = keep_targets
    assert ex.upload_band() == BAND
    tracing.record(False)
    tracing.clear()
    tracing.record(True)
    try:
        with open(ex.run(), encoding="utf-8") as f:
            srt = f.read()
        counters = tracing.counters()
    finally:
        tracing.record(False)
        tracing.clear()
    assert srt == jax_srt
    assert records(ex) == jax_records and len(records(ex)) > 0
    y0, y1 = BAND
    assert {o for _, o in engine.batches} == {(y0, 0)}
    got = np.concatenate([b for b, _ in engine.batches])
    if mode == "fast":
        # the scan: K2's stats on the area, the spans, as the JAX scan's
        ((stats, nos, spans),) = scans
        ((j_stats, j_nos, j_spans),) = jax_scans
        np.testing.assert_array_equal(nos, j_nos)
        np.testing.assert_array_equal(nos, np.arange(1, N + 1))
        area = np.zeros((-N % 32 + N, AREA[1] - AREA[0], AREA[3] - AREA[2], 3), np.uint8)
        area[:N] = frames[:, AREA[0] : AREA[1], AREA[2] : AREA[3]]
        want = torch.cat([scan_stats_u8(torch.from_numpy(area[i : i + 32]), ScanParams())
                          for i in range(0, len(area), 32)])[:N]
        np.testing.assert_array_equal(stats, want.numpy())
        np.testing.assert_allclose(stats, j_stats, rtol=1e-5, atol=1e-6)
        assert spans == j_spans and len(spans) == 2
        # the OCR pass: each chunk the stack of its samples' band
        assert len(targets) == len(got) > 0
        np.testing.assert_array_equal(got, frames[targets, y0:y1])
        share = (AREA[1] - AREA[0]) * (AREA[3] - AREA[2]) / (H * W)
    else:
        assert not scans and not jax_scans
        # every frame's band in full batches, the padding rows zero
        np.testing.assert_array_equal(got[:N], frames[:, y0:y1])
        assert len(got) % ex.config.frame_batch == 0 and not got[N:].any()
        # full-width rows of an in-memory frame are a contiguous view,
        # handed on with no copy; a file's BGR frame is flipped and copied
        share = (y1 - y0) / H if source == "opencv" else 0
    copied = sum(c.n for c in counters if c.name == "decode.copy_bytes")
    whole = sum(c.n for c in counters if c.name == "decode.frame_bytes")
    assert whole == N * H * W * 3 and copied == round(share * whole)
