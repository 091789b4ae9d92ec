"""Host -> device feed: overlap frame-batch uploads with the device's work
(the port of ``vse_tpu/pipeline/feed.py::device_prefetch``).

A feeder thread takes decoded batches and uploads each batch ``depth``
batches ahead of the consumer; a caller that reads a band of each frame
crops it in the stream's reader (``FrameStream(..., region=...)``), before
the batch is made. On the card a batch is staged in a page-locked host
buffer and copied with ``non_blocking=True`` on a side stream; the
consumer's stream waits on the copy's event before it reads the batch. On the CPU (an explicit ``device="cpu"``) the same thread hands
over contiguous host tensors, with no streams and no pinning.

Buffer reuse, the fault that would show as a wrong frame now and then
rather than as an error:

- a pinned buffer is rewritten only after the copy that read it has
  finished: each of the ring's ``depth + 2`` buffers carries the event of
  its last copy, and the feeder waits on it before staging into it;
- a device batch is a fresh allocation on the side stream, marked with
  ``record_stream`` for the consumer's stream, so the caching allocator
  hands its memory out again only after the consumer's work on it is done.

The side stream is one per device for the process (``_side_stream``): the
caching allocator keeps freed blocks per stream, and PyTorch hands out its
pool's 32 streams in turn, so a stream a call would leave one more cached
segment of batches per call, up to 32.

Spans (``utils/tracing.py``, no-ops unless recording), each with the
batch's sequence number ``batch``: on the feeder thread ``feed.ring_wait``
(a pinned buffer's last copy, on the card), ``feed.stage`` (the copy into
pinned memory; on the CPU into a contiguous array), ``feed.upload`` (the async copy's enqueue; on the CPU the hand-over
as a tensor) and ``feed.put_wait`` (the consumer behind); on the
consumer's thread ``feed.wait`` (blocked on the next batch).
"""

from __future__ import annotations

import functools
import itertools
import queue
import threading
from typing import Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from vse_tpu_torch.utils.tracing import annotate, carry
from vse_tpu_torch.video.decode import FrameBatch


class _PinnedRing:
    """``n`` page-locked staging buffers used in turn, each guarded by the
    event of the last copy that read it."""

    def __init__(self, n: int):
        self.bufs: List[Optional[torch.Tensor]] = [None] * n
        self.events: List[Optional[torch.cuda.Event]] = [None] * n
        self.next = 0

    def stage(self, frames: np.ndarray, seq: int) -> Tuple[torch.Tensor, int]:
        """Copy ``frames`` (batch ``seq``) into the next buffer (once its
        last copy is done); returns the buffer and its slot."""
        k = self.next
        self.next = (k + 1) % len(self.bufs)
        if self.events[k] is not None:
            with annotate("feed.ring_wait", batch=seq):
                self.events[k].synchronize()
        with annotate("feed.stage", batch=seq):
            buf = self.bufs[k]
            if buf is None or tuple(buf.shape) != frames.shape:
                buf = self.bufs[k] = torch.empty(frames.shape, dtype=torch.uint8,
                                                 pin_memory=True)
            buf.copy_(torch.from_numpy(frames))
        return buf, k


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream the uploads to ``device`` run on."""
    return torch.cuda.Stream(device)


def _upload(frames: np.ndarray, device: torch.device, ring: Optional[_PinnedRing],
            side: Optional["torch.cuda.Stream"], seq: int):
    """Batch ``seq`` onto ``device``: (tensor, event the consumer waits on)."""
    if ring is None:
        with annotate("feed.stage", batch=seq):
            frames = np.ascontiguousarray(frames)
        with annotate("feed.upload", batch=seq):
            return torch.from_numpy(frames), None
    pinned, k = ring.stage(frames, seq)
    with annotate("feed.upload", batch=seq), torch.cuda.stream(side):
        dev = torch.empty(pinned.shape, dtype=torch.uint8, device=device)
        dev.copy_(pinned, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    ring.events[k] = done
    return dev, done


def device_prefetch(
    batches: Iterable[FrameBatch],
    device: Union[str, torch.device] = "cuda",
    depth: int = 2,
) -> Iterator[Tuple[FrameBatch, torch.Tensor]]:
    """Yield ``(host_batch, device_frames)`` with uploads running ``depth``
    batches ahead, ``device_frames`` being the batch's frames as a
    contiguous uint8 tensor on ``device``, ready for work on the consumer's
    current stream.

    The feeder's bounded put gives up when the consumer is gone (an early
    exit such as ``ExtractionCancelled``), the decode generator is closed
    when the feeder ends, and a feeder error is raised in the consumer."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    on_card = device.type == "cuda"
    if on_card:
        device = torch.device("cuda", torch.cuda.current_device() if device.index is None
                              else device.index)
    side = _side_stream(device) if on_card else None
    ring = _PinnedRing(depth + 2) if on_card else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err: list = []
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put that gives up when the consumer is gone — otherwise an
        # early consumer exit leaves the feeder blocked on a full queue
        # forever, leaking the FrameStream and a thread per cancelled run
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def feeder():
        it = iter(batches)
        try:
            if on_card:
                torch.cuda.set_device(device)
            for seq, b in enumerate(it):
                if stop.is_set():
                    break
                item = (b, *_upload(b.frames, device, ring, side, seq))
                with annotate("feed.put_wait", batch=seq):
                    if not _put(item):
                        break
        except Exception as e:  # surface decode/upload errors to the consumer
            err.append(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()  # release the decode generator's reader
            _put(None)

    t = threading.Thread(target=carry(feeder), daemon=True)
    t.start()
    try:
        for seq in itertools.count():
            with annotate("feed.wait", batch=seq):
                item = q.get()
            if item is None:
                break
            b, dev, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(done)
                dev.record_stream(consumer)
            yield b, dev
    finally:
        stop.set()
        t.join(timeout=10)
    if err:
        raise err[0]
