"""The port's ffmpeg decoder (``FrameStream(..., decoder="ffmpeg")``,
``Decoder.FFMPEG``) against the JAX package's, through the same ffmpeg
shim as ``tests/test_decode_ffmpeg.py`` (a python script that decodes with
OpenCV and speaks ffmpeg's rawvideo pipe protocol, named by
``$VSE_FFMPEG``): the same frames, frame numbers and timestamps, with and
without a stride and a start frame; the missing-binary case falls back to
OpenCV with the reference's warning; a stream with a region is the full
stream cropped; and ``--config`` with
``scanner_decoder: ffmpeg`` extracts the JAX extractor's SRT with the same
config. Everything is compared exactly. (The reference stamps an
ffmpeg-decoded frame with the next frame's time, so its cues sit one frame
later than OpenCV's; the port does the same.)"""

import json
import os
import stat
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from _torch_helpers import jax_full_batches
from vse_tpu.core.config import VseConfig as JaxConfig
from vse_tpu.core.subtitle_area import SubtitleArea as JaxArea
from vse_tpu.pipeline.extractor import SubtitleExtractor as JaxExtractor
from vse_tpu.video.decode import FrameStream as JaxStream
from vse_tpu_torch import cli
from vse_tpu_torch.core.config import Decoder
from vse_tpu_torch.video import decode
from vse_tpu_torch.video.decode import FrameStream

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIM = open(os.path.join(ROOT, "tests", "test_decode_ffmpeg.py"), encoding="utf-8").read()
SHIM = SHIM[SHIM.index('SHIM = """') + len('SHIM = """'):]
SHIM = SHIM[: SHIM.index('"""')]


@pytest.fixture
def video(tmp_path):
    path = str(tmp_path / "v.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 25.0, (64, 48))
    rng = np.random.default_rng(0)
    for i in range(23):
        f = np.full((48, 64, 3), i * 10 % 255, np.uint8)
        f[10:20, 5:40] = rng.integers(0, 255, (10, 35, 3), np.uint8)
        vw.write(f)
    vw.release()
    return path


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    shim = tmp_path / "ffmpeg"
    shim.write_text(SHIM.format(python=sys.executable), encoding="utf-8")
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("VSE_FFMPEG", str(shim))
    return str(shim)


def collect(stream):
    frames, nos = [], []
    for b in stream:
        n = int(b.valid.sum())
        frames.append(b.frames[:n])
        nos.append(b.frame_nos[:n])
    return np.concatenate(frames), np.concatenate(nos), dict(stream.frame_to_ms)


@pytest.mark.parametrize("stride,start", [(1, 0), (4, 7)])
def test_ffmpeg_stream_matches_jax(video, fake_ffmpeg, stride, start):
    assert decode.ffmpeg_exe() == fake_ffmpeg
    kw = dict(batch_size=4, stride=stride, start_frame=start)
    want = collect(JaxStream(video, use_native_ring=False, decoder="ffmpeg", **kw))
    got = collect(FrameStream(video, decoder=Decoder.FFMPEG, **kw))
    opencv = collect(FrameStream(video, decoder="opencv", **kw))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2] and len(got[2]) == 23 - start
    np.testing.assert_array_equal(got[0], opencv[0])
    np.testing.assert_array_equal(got[1], opencv[1])


@pytest.mark.parametrize("stride,start,region", [(1, 0, (7, 31, 3, 45)), (4, 7, (-17, 99, 11, 64))])
def test_ffmpeg_region_stream_is_the_full_stream_cropped(video, fake_ffmpeg, stride, start, region):
    kw = dict(batch_size=4, stride=stride, start_frame=start, decoder="ffmpeg")
    y0, y1, x0, x1 = region
    got = collect(FrameStream(video, region=region, **kw))
    full = collect(FrameStream(video, **kw))
    np.testing.assert_array_equal(got[0], full[0][:, y0:y1, x0:x1])
    np.testing.assert_array_equal(got[1], full[1])
    assert got[2] == full[2] and len(got[1]) == len(range(start, 23, stride))


def test_missing_binary_falls_back_to_opencv_as_the_reference(video, monkeypatch):
    monkeypatch.setenv("VSE_FFMPEG", "/nonexistent/ffmpeg")
    monkeypatch.setenv("PATH", "/nonexistent")
    assert decode.ffmpeg_exe() is None
    with pytest.warns(UserWarning, match="falling back to OpenCV") as port_warn:
        s = FrameStream(video, batch_size=4, decoder="ffmpeg")
    with pytest.warns(UserWarning, match="falling back to OpenCV") as jax_warn:
        j = JaxStream(video, batch_size=4, decoder="ffmpeg", use_native_ring=False)
    assert str(port_warn[0].message) == str(jax_warn[0].message)
    assert s.decoder == j.decoder == "opencv"
    assert sum(int(b.valid.sum()) for b in s) == 23
    with pytest.raises(ValueError, match="decoder"):
        FrameStream(video, batch_size=4, decoder="gstreamer")


class ScriptedEngine:
    """Reads the stripe phase of a frame as text (no models), in both
    packages' engine contracts."""

    family = "en"

    class spec:  # noqa: N801
        rec_family = "en"

    def predict_batch(self, frames, origin=(0, 0)):
        out = []
        for f in np.asarray(frames):
            on = f[:, :, 0] > 128
            if not on.any():
                out.append(([], []))
                continue
            ys, xs = np.nonzero(on)
            dy, dx = origin
            quad = [(int(xs.min()) + dx, int(ys.min()) + dy), (int(xs.max()) + dx, int(ys.min()) + dy),
                    (int(xs.max()) + dx, int(ys.max()) + dy), (int(xs.min()) + dx, int(ys.max()) + dy)]
            text = "alpha beta" if xs.min() < 22 else "gamma delta"
            out.append(([quad], [(text, 0.95)]))
        return out


def test_config_scanner_decoder_ffmpeg_extracts_as_the_jax_package(tmp_path, fake_ffmpeg,
                                                                     monkeypatch):
    """``cli extract --config`` with the reference's ffmpeg decoder key, in
    mode fast (the keyframe scan) and mode accurate (per-frame detection):
    the SRT equals the JAX extractor's with the same config (the scripted
    engine stands in for the models on both sides)."""
    path = str(tmp_path / "c.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 25.0, (160, 96))
    for i in range(90):
        f = np.full((96, 160, 3), 30, np.uint8)
        if 10 <= i < 40 or 55 <= i < 85:
            f[60:80, 20 + 3 * (i >= 55) : 140 : 4] = 255
        vw.write(f)
    vw.release()
    from vse_tpu_torch.pipeline import extractor

    monkeypatch.setattr(extractor.SubtitleExtractor, "engine",
                        property(lambda self: ScriptedEngine()))
    cfg = tmp_path / "ffmpeg.json"
    cfg.write_text(json.dumps({"Main": {"VideoSubFinderDecoder": "VideoSubFinderDecoder.FFMPEG",
                                        "WordSegmentation": False}}), encoding="utf-8")
    for mode in ("fast", "accurate"):
        out = tmp_path / mode
        assert cli.main(["extract", path, "--area", "50,90,0,160", "--mode", mode,
                         "--config", str(cfg), "--output", str(out), "--device", "cpu"]) == 0
        got = (out / "c.srt").read_text(encoding="utf-8")
        jax = JaxExtractor(path, JaxArea(50, 90, 0, 160),
                           JaxConfig.from_json(str(cfg)).replace(mode=mode),
                           engine=ScriptedEngine())
        assert jax.config.scanner_decoder.value == "ffmpeg"
        jax.subtitle_output_path = str(tmp_path / f"jax_{mode}.srt")
        jax.append_output = lambda *a: None
        with jax_full_batches():
            with open(jax.run(), encoding="utf-8") as f:
                want = f.read()
        assert got == want and got.count("-->") == 2
