"""Host video decode -> frame batches (the port of
``vse_tpu/video/decode.py``: ``probe``, ``FrameStream``, ``read_frames``,
and the ffmpeg decoder, ``ffmpeg_exe`` and ``_FFmpegCapture``).

A video is either a path, decoded with OpenCV (imported lazily; a clear
error says so when it is missing), or an ``InMemoryVideo``: decoded uint8
RGB frames plus their fps, which the tests and ``chip_smoke.py`` use. Both
give the same frames and timestamps: frame k (1-based) of an in-memory clip
is stamped ``(k - 1) * 1000 / fps`` ms, which is what OpenCV reports for a
constant-frame-rate file. The frame queue is plain Python (a reader thread
and a bounded ``queue.Queue``); the JAX package's native ring buffer is not
used.

``FrameStream(..., region=(y0, y1, x0, x1))`` crops each sampled frame to
those rows and columns in the reader thread, before its first copy, and
yields batches of the crop: a caller that reads only the subtitle band
copies only the band. Without a region the batches hold whole frames.

The reader thread records ``decode.read`` (a frame's decode),
``decode.copy`` (the contiguous RGB copy of the frame, or of its region)
and ``decode.put_wait`` (the queue full), and counts ``decode.frame_bytes``
(a sampled frame's bytes) and ``decode.copy_bytes`` (the bytes its copy
wrote; none where the region of an in-memory frame is already contiguous
and is handed on as a view);
the batch assembly records ``stream.wait`` (waiting on the reader) and
``stream.assemble`` (the batch's copies and padding rows' zero-fill, attr
``batch``); ``read_frames`` records ``decode.samples`` (attr ``count``).
They are ``utils/tracing.py`` spans and counters, no-ops unless recording.

``FrameStream(..., decoder="ffmpeg")`` (``Decoder.FFMPEG``, the config's
``scanner_decoder``) decodes a file through an ffmpeg rawvideo pipe: the
binary named by ``$VSE_FFMPEG``, else ``ffmpeg`` on ``PATH``. Without one it
warns and decodes with OpenCV, as the reference does. Probing and
``read_frames`` stay on OpenCV, as in the reference.
"""

from __future__ import annotations

import os
import queue
import shutil
import subprocess
import threading
import warnings
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from vse_tpu_torch.utils.tracing import annotate, carry, count

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


def ffmpeg_exe() -> Optional[str]:
    """The ffmpeg binary: ``$VSE_FFMPEG`` when that file exists, else
    ``ffmpeg`` on ``PATH``, else None (reference backend/main.py:491-495
    passes --open_video_ffmpeg to its scanner)."""
    env = os.environ.get("VSE_FFMPEG")
    if env and os.path.exists(env):
        return env
    return shutil.which("ffmpeg")


class _FFmpegCapture:
    """The ``cv2.VideoCapture`` surface that ``FrameStream`` reads, over an
    ffmpeg rawvideo pipe: ``read()``, ``get(CAP_PROP_POS_MSEC)``,
    ``set(CAP_PROP_POS_FRAMES)`` before the first read (an ``-ss`` start),
    ``release()``. Frames come out BGR, as from OpenCV. A frame's timestamp
    is the next frame's index / fps, as the reference computes it (a
    constant frame rate)."""

    def __init__(self, path: str, meta: "VideoMeta"):
        self.path = path
        self.meta = meta
        self._frame_bytes = meta.height * meta.width * 3
        self._proc = None
        self._pos = 0  # 0-based index of the next frame read() returns
        self._cv2 = _cv2()

    def _spawn(self) -> None:
        exe = ffmpeg_exe()
        if exe is None:
            raise FileNotFoundError("ffmpeg binary not found")
        args = [exe, "-nostdin", "-loglevel", "error"]
        if self._pos > 0 and self.meta.fps:
            args += ["-ss", f"{self._pos / self.meta.fps:.6f}"]
        args += ["-i", self.path, "-f", "rawvideo", "-pix_fmt", "bgr24", "pipe:1"]
        self._proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL,
                                      bufsize=self._frame_bytes * 4)

    def set(self, prop, value) -> bool:
        if prop == self._cv2.CAP_PROP_POS_FRAMES and self._proc is None:
            self._pos = int(value)
            return True
        return False

    def get(self, prop) -> float:
        if prop == self._cv2.CAP_PROP_POS_MSEC:
            return self._pos / self.meta.fps * 1000.0 if self.meta.fps else 0.0
        return 0.0

    def read(self):
        if self._proc is None:
            self._spawn()
        out = self._proc.stdout
        chunks, need = [], self._frame_bytes
        while need:
            b = out.read(need)
            if not b:
                return False, None
            chunks.append(b)
            need -= len(b)
        frame = np.frombuffer(b"".join(chunks), np.uint8).reshape(
            self.meta.height, self.meta.width, 3)
        self._pos += 1
        return True, frame

    def release(self) -> None:
        if self._proc is None:
            return
        self._proc.stdout.close()
        self._proc.terminate()
        try:
            self._proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()
        self._proc = None


def _contiguous(view: np.ndarray) -> np.ndarray:
    """``np.ascontiguousarray(view)`` of a uint8 [..., 3] view. A
    channel-reversed view (a BGR frame read as RGB) is copied a channel at a
    time: numpy copies its reversed 3-element rows element by element, about
    4x slower than three strided planes."""
    if view.strides[-1] >= 0:
        return np.ascontiguousarray(view)
    out = np.empty(view.shape, view.dtype)
    for c in range(view.shape[-1]):
        out[..., c] = view[..., c]
    return out


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

    ``region=(y0, y1, x0, x1)`` keeps only ``frame[y0:y1, x0:x1]`` of each
    frame (numpy's slice bounds, clipped to the frame): the reader copies
    just that, and the batches are ``[B, y1 - y0, x1 - x0, 3]``.

    ``stride`` samples fps-mode style: emit one frame, skip ``stride - 1``
    (the reference's ``fps // extractFrequency`` skip loop, backend/main.py:
    246-252). Decoding starts after the first ``start_frame`` frames and
    stops after frame ``end_frame`` (1-based, inclusive). ``frame_to_ms``
    collects the timestamp of every decoded frame, sampled or not, as the
    JAX package's stream does."""

    def __init__(self, video: Video, batch_size: int, stride: int = 1,
                 start_frame: int = 0, end_frame: Optional[int] = None,
                 decoder: str = "opencv",
                 region: Optional[Tuple[int, int, int, int]] = None):
        self.video = video
        self.meta = probe(video)
        y0, y1, x0, x1 = region if region is not None else (None,) * 4
        ys, xs = range(self.meta.height)[y0:y1], range(self.meta.width)[x0:x1]
        self.region = (ys.start, ys.stop, xs.start, xs.stop)  # the whole frame without one
        self.batch_size = batch_size
        self.stride = max(1, stride)
        self.start_frame = start_frame
        self.end_frame = end_frame
        self.frame_to_ms: dict = {}
        self.decoder = getattr(decoder, "value", decoder)  # Decoder or str
        if self.decoder not in ("opencv", "ffmpeg"):
            raise ValueError(f"unknown decoder {decoder!r}")
        if self.decoder == "ffmpeg" and ffmpeg_exe() is None:
            warnings.warn(
                "Decoder.FFMPEG requested but no ffmpeg binary found; "
                "falling back to OpenCV decode",
                stacklevel=2,
            )
            self.decoder = "opencv"

    def _frames(self) -> Iterator[Tuple[np.ndarray, int, float]]:
        """(RGB frame, 1-based frame number, timestamp ms) in decode order,
        from frame ``start_frame + 1`` on."""
        if isinstance(self.video, InMemoryVideo):
            for i in range(self.start_frame, len(self.video.frames)):
                with annotate("decode.read"):
                    frame = self.video.frames[i]
                yield frame, i + 1, i * 1000.0 / self.video.fps
            return
        cv2 = _cv2()
        if self.decoder == "ffmpeg":
            cap = _FFmpegCapture(self.video, self.meta)
        else:
            cap = cv2.VideoCapture(self.video)
        try:
            frame_no = 0
            if self.start_frame > 0:
                cap.set(cv2.CAP_PROP_POS_FRAMES, self.start_frame)
                frame_no = self.start_frame
            while True:
                with annotate("decode.read"):
                    ret, frame = cap.read()
                if not ret:
                    break
                frame_no += 1
                yield frame[:, :, ::-1], frame_no, float(cap.get(cv2.CAP_PROP_POS_MSEC))
        finally:
            cap.release()

    def _decode_loop(self, q: "queue.Queue", stop: threading.Event) -> None:
        y0, y1, x0, x1 = self.region
        frames = self._frames()
        try:
            for frame, no, ts in frames:
                if stop.is_set() or (self.end_frame is not None and no > self.end_frame):
                    break
                self.frame_to_ms[no] = ts
                if (no - self.start_frame - 1) % self.stride == 0:
                    with annotate("decode.copy"):
                        out = _contiguous(frame[y0:y1, x0:x1])
                    count("decode.frame_bytes", frame.nbytes)
                    if not np.may_share_memory(out, frame):  # a contiguous view is handed on
                        count("decode.copy_bytes", out.nbytes)
                    with annotate("decode.put_wait"):
                        q.put((out, no))
        finally:
            frames.close()  # release the capture now, not at collection
            q.put(None)

    def __iter__(self) -> Iterator[FrameBatch]:
        y0, y1, x0, x1 = self.region
        shape = (y1 - y0, x1 - x0, 3)
        q: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
        stop = threading.Event()
        t = threading.Thread(target=carry(self._decode_loop), args=(q, stop), daemon=True)
        t.start()
        try:
            done = False
            seq = 0
            while not done:
                take: List[Tuple[np.ndarray, int]] = []
                with annotate("stream.wait", batch=seq):
                    while len(take) < self.batch_size:
                        item = q.get()
                        if item is None:
                            done = True
                            break
                        take.append(item)
                if not take:
                    break
                with annotate("stream.assemble", batch=seq):
                    frames = np.empty((self.batch_size,) + shape, np.uint8)
                    frames[len(take):] = 0
                    nos = np.zeros((self.batch_size,), np.int64)
                    valid = np.zeros((self.batch_size,), bool)
                    for i, (f, no) in enumerate(take):
                        frames[i], nos[i], valid[i] = f, no, True
                seq += 1
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
    with annotate("decode.samples", count=len(frame_idx)):
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
