"""The port's frame stream and device feed on the CPU.

- ``FrameStream`` with a stride, a start frame and an end frame yields the
  same frame numbers, valid masks, frames and ``frame_to_ms`` as the JAX
  package's stream (its Python queue, which always fills a batch), on an
  FFV1 file through OpenCV and on an ``InMemoryVideo``.
- ``FrameStream(..., region=r)`` yields the full stream's batches cropped
  to ``r`` (numpy's slice bounds), with the same frame numbers, valid
  masks, ``frame_to_ms`` and zeroed padding rows, as C-contiguous arrays.
- ``device_prefetch`` with ``device="cpu"``: batches in order, a region
  stream's crops uploaded, a feeder error raised in the consumer, and the feeder
  thread and the decode generator ended when the consumer stops early.
All comparisons are exact.
"""

import threading
import time

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from vse_tpu.video.decode import FrameStream as JaxStream
from vse_tpu_torch.pipeline.feed import device_prefetch
from vse_tpu_torch.video.decode import FrameBatch, FrameStream, InMemoryVideo

FPS, N, H, W = 25.0, 47, 36, 64


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (N, H, W, 3)).astype(np.uint8)
    path = str(tmp_path_factory.mktemp("feed") / "clip.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), FPS, (W, H))
    for f in frames:
        vw.write(np.ascontiguousarray(f[:, :, ::-1]))
    vw.release()
    return path, frames


def collect(stream):
    batches = list(stream)
    return (np.stack([b.frame_nos for b in batches]), np.stack([b.valid for b in batches]),
            np.stack([b.frames for b in batches]), dict(stream.frame_to_ms))


@pytest.mark.parametrize("batch,stride,start,end", [
    (8, 1, 0, None), (8, 8, 0, None), (3, 5, 10, None), (4, 3, 7, 30), (32, 1, 0, 40),
])
def test_frame_stream_matches_jax(clip, batch, stride, start, end):
    path, frames = clip
    kw = dict(batch_size=batch, stride=stride, start_frame=start, end_frame=end)
    nos, valid, got, to_ms = collect(FrameStream(path, **kw))
    r_nos, r_valid, want, r_to_ms = collect(JaxStream(path, use_native_ring=False, **kw))
    np.testing.assert_array_equal(nos, r_nos)
    np.testing.assert_array_equal(valid, r_valid)
    np.testing.assert_array_equal(got, want)
    assert to_ms == r_to_ms
    last = end if end is not None else N
    sampled = list(range(start + 1, last + 1, stride))
    assert nos[valid].tolist() == sampled and not got[~valid].any()
    assert sorted(to_ms) == list(range(start + 1, last + 1))
    # an in-memory clip of the same frames: same batches, stamps (k-1)*1000/fps
    m_nos, m_valid, m_frames, m_to_ms = collect(
        FrameStream(InMemoryVideo(frames, FPS, "mem.avi"), **kw))
    np.testing.assert_array_equal(m_nos, nos)
    np.testing.assert_array_equal(m_valid, valid)
    np.testing.assert_array_equal(m_frames, got)
    assert m_to_ms == {k: (k - 1) * 1000.0 / FPS for k in to_ms}
    assert all(abs(m_to_ms[k] - to_ms[k]) < 1e-6 for k in to_ms)


@pytest.mark.parametrize("source", ["opencv", "memory"])
@pytest.mark.parametrize("batch,stride,start,end,region", [
    (8, 1, 0, None, (5, 28, 7, 51)), (3, 5, 10, None, (11, 36, 1, 63)),
    (4, 3, 7, 30, (3, 33, 9, 19)), (32, 1, 0, 40, (-13, 99, 21, 200)),
])
def test_region_stream_is_the_full_stream_cropped(clip, source, batch, stride, start, end, region):
    path, frames = clip
    video = path if source == "opencv" else InMemoryVideo(frames, FPS, "mem.avi")
    kw = dict(batch_size=batch, stride=stride, start_frame=start, end_frame=end)
    y0, y1, x0, x1 = region
    streams = FrameStream(video, region=region, **kw), FrameStream(video, **kw)
    got, want = (list(s) for s in streams)
    assert len(got) == len(want) > 0
    for b, full in zip(got, want):
        assert b.frames.flags.c_contiguous and b.frames.dtype == np.uint8
        np.testing.assert_array_equal(b.frames, full.frames[:, y0:y1, x0:x1])
        np.testing.assert_array_equal(b.frame_nos, full.frame_nos)
        np.testing.assert_array_equal(b.valid, full.valid)
        assert not b.frames[~b.valid].any()
    assert streams[0].frame_to_ms == streams[1].frame_to_ms
    assert got[0].frames.shape[1:] == frames[0, y0:y1, x0:x1].shape


def batches(n, shape=(4, 6, 10, 3), fail_at=None, log=None):
    """Batches whose frames hold their index everywhere; optionally raises
    at batch ``fail_at``; records its close in ``log``."""
    try:
        for i in range(n):
            if i == fail_at:
                raise RuntimeError(f"decode failed at {i}")
            yield FrameBatch(np.full(shape, i, np.uint8), np.arange(4) + 4 * i + 1,
                             np.ones(4, bool))
    finally:
        if log is not None:
            log.append("closed")


def feeder_threads():
    return [t for t in threading.enumerate() if t.daemon and t.is_alive()]


def test_prefetch_order_and_transform():
    """Batches in order; the crop is the stream's region, made in its reader."""
    frames = np.broadcast_to(np.arange(80, dtype=np.uint8)[:, None, None, None], (80, 6, 10, 3))
    stream = FrameStream(InMemoryVideo(np.ascontiguousarray(frames), FPS, "mem.avi"), 4,
                         region=(1, 4, 2, 7))
    got = list(device_prefetch(stream, "cpu"))
    assert len(got) == 20
    for i, (b, dev) in enumerate(got):
        assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
        assert dev.shape == (4, 3, 5, 3) and dev.is_contiguous()
        assert torch.equal(dev, torch.arange(4 * i, 4 * i + 4, dtype=torch.uint8)
                           .view(4, 1, 1, 1).expand(4, 3, 5, 3))
        assert b.frame_nos[0] == 4 * i + 1
    got = list(device_prefetch(batches(3), "cpu", depth=1))
    assert [int(d[0, 0, 0, 0]) for _, d in got] == [0, 1, 2]
    assert got[0][1].shape == (4, 6, 10, 3)


def test_prefetch_raises_the_feeders_error_in_the_consumer():
    log = []
    seen = []
    with pytest.raises(RuntimeError, match="decode failed at 3"):
        for _, dev in device_prefetch(batches(9, fail_at=3, log=log), "cpu"):
            seen.append(int(dev[0, 0, 0, 0]))
    assert seen == [0, 1, 2] and log == ["closed"]


def consume(log, how):
    """A consumer that stops after two batches, as the extractor's loop does
    on a cancel (an exception) or a caller on a break."""
    for i, _ in enumerate(device_prefetch(batches(1000, log=log), "cpu", depth=2)):
        if i == 1:
            if how == "break":
                break
            raise KeyError("cancelled")


@pytest.mark.parametrize("how", ["break", "exception"])
def test_prefetch_feeder_ends_when_the_consumer_stops(how):
    before = len(feeder_threads())
    log = []
    if how == "break":
        consume(log, how)
    else:
        with pytest.raises(KeyError):
            consume(log, how)
    deadline = time.monotonic() + 10
    while len(feeder_threads()) > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert len(feeder_threads()) == before and log == ["closed"]


def test_prefetch_refuses_other_devices():
    with pytest.raises(ValueError):
        next(device_prefetch(batches(1), "meta"))
