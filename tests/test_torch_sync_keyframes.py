"""The sync re-timer's demuxer and keyframe log (``vse_tpu_torch/sync/
demux.py``) and K2's gray form against the JAX package on the CPU.

- ``parse_ffmpeg_info``, and the demuxer and the timecode fallback raising
  ``SyncError`` without ffmpeg or mkvextract, as the reference's do.
- ``make_keyframes``: scene-cut clips written once with OpenCV (the one of
  ``tests/test_sync.py``, and a 720p one whose decimated frames are the
  sync path's [33, 184, 384] padded batches) read by both packages: the
  SCXviD logs byte-equal, from a path and from an ``InMemoryVideo``.
- ``frame_stats_gray_plain`` on those decimated frames against the JAX
  package's ``frame_stats`` (jitted jnp on the CPU) and
  ``frame_stats_pallas(..., interpret=True)``: ``text_cells`` exact, the
  other stats within rtol 1e-5 (sums in another order); the wrapper on a
  CPU tensor is the plain version and launches nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from vse_tpu.kernels import keyframe as j_k2
from vse_tpu.sync import common as j_common
from vse_tpu.sync import demux as j_demux
from vse_tpu_torch.kernels import keyframe as k2
from vse_tpu_torch.sync import common, demux
from vse_tpu_torch.sync.timecodes import parse_keyframes
from vse_tpu_torch.video.decode import InMemoryVideo

FFMPEG_OUT = """Input #0, matroska,webm, from 'ep01.mkv':
  Duration: 00:23:40.03, start: 0.000000, bitrate: 2000 kb/s
    Chapter #0:0: start 0.000000, end 90.023000
    Chapter #0:1: start 90.023000, end 1420.030000
    Stream #0:0: Video: h264 (High), yuv420p, 1920x1080, 23.98 fps (default)
    Stream #0:1(jpn): Audio: aac (LC), 48000 Hz, stereo, fltp (default)
    Stream #0:2(eng): Audio: ac3, 48000 Hz, 5.1(side), fltp
    Stream #0:3(eng): Subtitle: ass (default)
    Stream #0:4(eng): Subtitle: subrip
"""


def test_parse_ffmpeg_info():
    a, b = demux.parse_ffmpeg_info(FFMPEG_OUT), j_demux.parse_ffmpeg_info(FFMPEG_OUT)
    for kind in ("video", "audio", "subtitles"):
        assert [vars(s) for s in getattr(a, kind)] == [vars(s) for s in getattr(b, kind)]
    assert a.chapter_times == b.chapter_times == [0.0, 90.023]
    assert [s.id for s in a.audio] == [1, 2] and a.audio[0].default


def test_demuxer_needs_ffmpeg_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.delenv("VSE_FFMPEG", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))  # neither ffmpeg nor mkvextract
    video = tmp_path / "ep.mkv"
    video.write_bytes(b"")
    msgs = []
    for mod, err in ((demux, common.SyncError), (j_demux, j_common.SyncError)):
        with pytest.raises(err) as e:
            mod.Demuxer(str(video))
        msgs.append(str(e.value))
        with pytest.raises(err):
            mod.mkvextract_timecodes(str(video), 0, str(tmp_path / "tc.txt"))
        d = mod.Demuxer(str(tmp_path / "a.WAV"))
        assert d.is_wav and d.chapters == [] and not d.has_video
        d.demux()  # nothing to do for a WAV
    assert msgs[0] == msgs[1]


def scene_cut_clip(path, size, n_scenes, frames_each, pan, seed=0):
    """``tests/test_sync.py``'s clip (``pan`` 0: static random scenes, each
    held for ``frames_each`` frames), or its scenes panned ``pan`` pixels a
    frame, at ``size``."""
    w, h = size
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (w, h))
    rng = np.random.default_rng(seed)
    scenes = [rng.integers(0, 255, size=(h, w + pan * frames_each, 3), dtype=np.uint8)
              for _ in range(n_scenes)]
    for scene in scenes:
        for k in range(frames_each):
            vw.write(np.ascontiguousarray(scene[:, pan * k : pan * k + w]))
    vw.release()


def decoded(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[:, :, ::-1])
    cap.release()
    return np.stack(frames)


# (size, scenes, frames a scene, pan): tests/test_sync.py's clip, it panned,
# and a 720p one whose batches are the sync path's [33, 184, 384]
CLIPS = {"test_sync": ((320, 240), 3, 40, 0), "320x240_pan": ((320, 240), 3, 40, 1),
         "720p_pan": ((1280, 720), 2, 23, 1)}


@pytest.fixture(scope="module", params=sorted(CLIPS))
def clip(request, tmp_path_factory):
    size, n, each, pan = CLIPS[request.param]
    path = str(tmp_path_factory.mktemp("kf") / f"cuts_{request.param}.mp4")
    scene_cut_clip(path, size, n, each, pan)
    return path, n, each


def test_make_keyframes_log_equals_the_jax_log(clip, tmp_path):
    path, n, each = clip
    logs = []
    for name, fn in (("port", lambda p, o: demux.make_keyframes(p, o, device="cpu")),
                     ("jax", j_demux.make_keyframes),
                     ("mem", lambda p, o: demux.make_keyframes(
                         InMemoryVideo(decoded(p), 25.0, p), o, device="cpu"))):
        out = str(tmp_path / f"{name}.log")
        fn(path, out)
        with open(out, "rb") as f:
            logs.append(f.read())
    assert logs[0] == logs[1] == logs[2]
    kfs = parse_keyframes(str(tmp_path / "port.log"))
    assert kfs[0] == 0 and all(any(abs(k - c) <= 1 for k in kfs) for c in range(each, n * each, each))


def test_make_keyframes_needs_cuda_unless_asked_for_cpu(clip, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demux.make_keyframes(clip[0], str(tmp_path / "kf.log"))
    with pytest.raises(common.SyncError):
        demux.make_keyframes(InMemoryVideo(np.zeros((0, 8, 8, 3), np.uint8), 25.0, "e"),
                             str(tmp_path / "kf.log"), device="cpu")


def sync_batches(path):
    """The sync path's gray batches: 32 decoded frames at a time,
    decimated 4x, the JAX package's eager gray, the previous batch's last
    frame prepended (f32 [<= 33, h, w], unpadded)."""
    frames = decoded(path)
    out, tail = [], None
    for i in range(0, len(frames), 32):
        gray = np.array(j_k2.rgb_to_gray(jnp.asarray(frames[i : i + 32, ::4, ::4])))
        out.append(gray if tail is None else np.concatenate([tail, gray]))
        tail = gray[-1:]
    return out


def test_gray_form_plain_matches_jax(clip):
    for gray in sync_batches(clip[0]):
        want = j_k2.frame_stats(gray, force_jnp=True)
        padded = j_k2._pad_hw(gray, j_k2.ScanParams())
        pallas = np.asarray(j_k2.frame_stats_pallas(jnp.asarray(padded), interpret=True))
        before = k2.launches
        for x in (torch.from_numpy(gray), torch.from_numpy(padded)):
            got = k2.frame_stats_gray(x).numpy()
            np.testing.assert_array_equal(got, k2.frame_stats_gray_plain(x).numpy())
            for ref in (want, pallas):
                np.testing.assert_array_equal(got[:, 1], ref[:, 1])
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        assert k2.launches == before
        assert padded.shape[1:] in ((64, 128), (184, 384)) and want[:, 1].max() > 0


def test_eager_gray_rounds_as_the_source_order(clip):
    """The port's eager gray of the decoded frames is bit-equal to the JAX
    package's eager ``rgb_to_gray`` (all 2^24 colours:
    ``tests/test_torch_kernel_repairs.py``)."""
    frames = decoded(clip[0])[:8, ::4, ::4]
    want = np.asarray(j_k2.rgb_to_gray(jnp.asarray(frames)))
    got = k2.rgb_to_gray_eager(torch.from_numpy(np.ascontiguousarray(frames))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_gray_wrappers_refuse_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        k2.frame_stats_gray_cuda(torch.zeros((2, 8, 8)))  # not a CUDA tensor
    with pytest.raises(ValueError):
        k2.frame_stats_gray(torch.zeros((2, 8, 8), device="meta"))
