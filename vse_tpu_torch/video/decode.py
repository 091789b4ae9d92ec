"""Host video decode -> frame batches (the port of the main-path parts of
``vse_tpu/video/decode.py``: ``probe``, ``FrameStream``, ``read_frames``).

A video is either a path, decoded with OpenCV (imported lazily; a clear
error says so when it is missing), or an ``InMemoryVideo``: decoded uint8
RGB frames plus their fps, which the tests and ``chip_smoke.py`` use. Both
give the same frames and timestamps: frame k (1-based) of an in-memory clip
is stamped ``(k - 1) * 1000 / fps`` ms, which is what OpenCV reports for a
constant-frame-rate file. The frame queue is plain Python (a reader thread
and a bounded ``queue.Queue``); the JAX package's native ring buffer is not
used.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

QUEUE_DEPTH = 64  # decoded frames buffered ahead of the consumer
SEEK_GAP = 300  # read_frames seeks over gaps longer than this many frames


def _cv2():
    try:
        import cv2
    except ImportError as e:  # the card's machine has no OpenCV
        raise ImportError(
            "decoding a video file needs OpenCV (cv2), which is not "
            "installed; pass an InMemoryVideo of decoded frames instead"
        ) from e
    return cv2


@dataclass
class InMemoryVideo:
    """Decoded uint8 RGB frames [N, H, W, 3] at ``fps``. ``path`` only names
    the outputs (the SRT is written next to it); no file is read."""

    frames: np.ndarray
    fps: float
    path: str

    def __post_init__(self):
        if self.frames.dtype != np.uint8 or self.frames.ndim != 4 or self.frames.shape[-1] != 3:
            raise ValueError("InMemoryVideo takes uint8 frames [N, H, W, 3]")
        if self.fps <= 0:
            raise ValueError("InMemoryVideo needs fps > 0")


Video = Union[str, InMemoryVideo]


def video_path(video: Video) -> str:
    return video.path if isinstance(video, InMemoryVideo) else video


@dataclass
class VideoMeta:
    fps: float
    frame_count: int
    height: int
    width: int


def probe(video: Video) -> VideoMeta:
    """Video metadata: fps, frame count and size."""
    if isinstance(video, InMemoryVideo):
        n, h, w, _ = video.frames.shape
        return VideoMeta(float(video.fps), n, h, w)
    cv2 = _cv2()
    cap = cv2.VideoCapture(video)
    try:
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {video}")
        return VideoMeta(
            fps=float(cap.get(cv2.CAP_PROP_FPS)) or 25.0,
            frame_count=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        )
    finally:
        cap.release()


@dataclass
class FrameBatch:
    """A contiguous stack of decoded frames plus their metadata."""

    frames: np.ndarray  # [B, H, W, 3] uint8 RGB
    frame_nos: np.ndarray  # [B] int64, 1-based like the reference's counter
    valid: np.ndarray  # [B] bool — False rows are padding


class FrameStream:
    """Single-pass decoded frame stream with fixed-size batches (the last
    one zero-padded, ``valid`` False on the padding). A reader thread
    decodes ahead into a bounded queue.

    ``stride`` samples fps-mode style: emit one frame, skip ``stride - 1``
    (the reference's ``fps // extractFrequency`` skip loop, backend/main.py:
    246-252). Decoding starts after the first ``start_frame`` frames and
    stops after frame ``end_frame`` (1-based, inclusive). ``frame_to_ms``
    collects the timestamp of every decoded frame, sampled or not, as the
    JAX package's stream does."""

    def __init__(self, video: Video, batch_size: int, stride: int = 1,
                 start_frame: int = 0, end_frame: Optional[int] = None):
        self.video = video
        self.meta = probe(video)
        self.batch_size = batch_size
        self.stride = max(1, stride)
        self.start_frame = start_frame
        self.end_frame = end_frame
        self.frame_to_ms: dict = {}

    def _frames(self) -> Iterator[Tuple[np.ndarray, int, float]]:
        """(RGB frame, 1-based frame number, timestamp ms) in decode order,
        from frame ``start_frame + 1`` on."""
        if isinstance(self.video, InMemoryVideo):
            for i in range(self.start_frame, len(self.video.frames)):
                yield self.video.frames[i], i + 1, i * 1000.0 / self.video.fps
            return
        cv2 = _cv2()
        cap = cv2.VideoCapture(self.video)
        try:
            frame_no = 0
            if self.start_frame > 0:
                cap.set(cv2.CAP_PROP_POS_FRAMES, self.start_frame)
                frame_no = self.start_frame
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                frame_no += 1
                yield frame[:, :, ::-1], frame_no, float(cap.get(cv2.CAP_PROP_POS_MSEC))
        finally:
            cap.release()

    def _decode_loop(self, q: "queue.Queue", stop: threading.Event) -> None:
        frames = self._frames()
        try:
            for frame, no, ts in frames:
                if stop.is_set() or (self.end_frame is not None and no > self.end_frame):
                    break
                self.frame_to_ms[no] = ts
                if (no - self.start_frame - 1) % self.stride == 0:
                    q.put((np.ascontiguousarray(frame), no))
        finally:
            frames.close()  # release the capture now, not at collection
            q.put(None)

    def __iter__(self) -> Iterator[FrameBatch]:
        shape = (self.meta.height, self.meta.width, 3)
        q: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
        stop = threading.Event()
        t = threading.Thread(target=self._decode_loop, args=(q, stop), daemon=True)
        t.start()
        try:
            done = False
            while not done:
                take: List[Tuple[np.ndarray, int]] = []
                while len(take) < self.batch_size:
                    item = q.get()
                    if item is None:
                        done = True
                        break
                    take.append(item)
                if not take:
                    break
                frames = np.zeros((self.batch_size,) + shape, np.uint8)
                nos = np.zeros((self.batch_size,), np.int64)
                valid = np.zeros((self.batch_size,), bool)
                for i, (f, no) in enumerate(take):
                    frames[i], nos[i], valid[i] = f, no, True
                yield FrameBatch(frames, nos, valid)
        finally:
            stop.set()
            while t.is_alive():  # unblock a reader waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


def read_frames(video: Video, frame_idx: Sequence[int]) -> List[Optional[np.ndarray]]:
    """RGB frames at 0-based indices (negative ones read frame 0), in the
    caller's order (None where a frame does not exist). A file is read in
    one sorted pass: small gaps are skipped with grab(), gaps over
    ``SEEK_GAP`` frames seek."""
    if isinstance(video, InMemoryVideo):
        n = len(video.frames)
        return [video.frames[max(0, i)] if i < n else None for i in frame_idx]
    cv2 = _cv2()
    order = np.argsort(frame_idx, kind="stable")
    out: List[Optional[np.ndarray]] = [None] * len(frame_idx)
    cap = cv2.VideoCapture(video)
    try:
        pos = 0  # next frame index the decoder will return (0-based)
        for oi in order:
            target = max(0, int(frame_idx[oi]))
            if target < pos or target - pos > SEEK_GAP:
                cap.set(cv2.CAP_PROP_POS_FRAMES, target)
                pos = target
            while pos < target:
                if not cap.grab():
                    break
                pos += 1
            ret, frame = cap.read()
            if not ret:
                continue
            pos += 1
            out[oi] = frame[:, :, ::-1]
    finally:
        cap.release()
    return out
