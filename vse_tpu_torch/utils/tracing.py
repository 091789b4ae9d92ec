"""The port's tracing: spans and counters recorded where the work happens,
and a torch.profiler exporter (the port of ``vse_tpu/utils/tracing.py``,
extended).

``annotate(name, **attrs)`` marks a span (a context manager) and
``count(name, n)`` a counter. The pipeline calls them at each stage: the
decode thread, the frame stream's batch assembly and the feeder thread
(``video/decode.py``, ``pipeline/feed.py``), the extractor's passes, the
scan, the OCR step and its parts, the graph captures and the span tracker
(``PERF.md`` §3 lists every name). Both are off by default: ``annotate``
then returns one shared no-op context and ``count`` returns at once, after
one check of a module flag; an attribute is a reference the caller holds,
and a tensor or array attribute is turned into its shape only when the
span is kept.

``record(True)`` switches recording on. Spans are kept in memory, under a
lock, as ``Span(name, start_ns, end_ns, thread, parent, clip, attrs, id)``:
``thread`` is ``threading.get_ident()``, ``parent`` the id of the innermost
span open on the same thread when the span began (None at a root),
``clip`` the id that the enclosing ``clip()`` scope gave the thread
(``SubtitleExtractor.run`` opens one a run; the threads a run starts carry
its id through ``carry``). Counters are kept as ``Counter(name, t_ns, n,
thread, clip)``. ``spans()`` and ``counters()`` return copies; ``clear()``
empties both.

Timestamps are on the profiler's clock: the Unix-epoch nanoseconds that
``torch.profiler``'s host and device records carry
(``prof.profiler.kineto_results.events()``; a Chrome trace's ``ts`` in
microseconds after its ``baseTimeNanoseconds``). A span is stamped with
``time.perf_counter_ns()`` plus one offset to ``time.time_ns()`` taken when
recording starts, so it can be laid against the device records of the
same process. The profiler's own conversion of its clock to Unix time sits
a few microseconds off (about 6 us late against this offset in a CPU
probe on torch 2.13), far under the spans and gaps it is read for.

``trace_context(dir)`` (or ``VSE_TRACE_DIR``) profiles the enclosed block
into a Chrome trace and records spans meanwhile; each span is then also a
``torch.profiler.record_function`` range and, with CUDA, an NVTX range, so
that the trace shows them. Outside it no span makes a ``record_function``:
a profiler that someone else runs sees none of the program's spans, and
no copy of them on its device timeline.

The profiler can drop a kernel's device record (its log counts it as
"Out-of-range": outside the capture window once the device's timestamps
are converted to the host clock), more often in a process that has run for
minutes; the host-side launch record stays. Count launches from those
(``chip_smoke.py`` phase 13 does, in a span around each launch).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[int]
    clip: Optional[int]
    attrs: Dict[str, Any]
    id: int


class Counter(NamedTuple):
    name: str
    t_ns: int
    n: int
    thread: int
    clip: Optional[int]


_recording = False  # spans and counters are kept
_profiled = False  # spans are also record_function and NVTX ranges
_offset_ns = 0  # time.time_ns() - time.perf_counter_ns() at the start of recording
_lock = threading.Lock()
_spans: List[Span] = []
_counters: List[Counter] = []
_span_ids = itertools.count(1)
_clip_ids = itertools.count(1)
_local = threading.local()  # .stack: ids of the open spans; .clip


def record(on: bool = True) -> None:
    """Switch recording on or off. What was recorded stays until
    ``clear()``."""
    global _recording, _offset_ns
    if on and not _recording:
        _offset_ns = time.time_ns() - time.perf_counter_ns()
    _recording = on


def recording() -> bool:
    return _recording


def now_ns() -> int:
    """The recorder's clock: Unix-epoch nanoseconds, as the profiler's."""
    return time.perf_counter_ns() + _offset_ns


def spans() -> List[Span]:
    with _lock:
        return list(_spans)


def counters() -> List[Counter]:
    with _lock:
        return list(_counters)


def clear() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _plain(v):
    shape = getattr(v, "shape", None)
    return tuple(shape) if shape is not None else v


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start", "ranges")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_span_ids)
        stack.append(self.id)
        self.ranges = None
        self.start = now_ns()
        if _profiled:
            nvtx = torch.cuda.is_available()
            if nvtx:
                torch.cuda.nvtx.range_push(self.name)
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
            self.ranges = (rf, nvtx)
        return self

    def __exit__(self, *exc):
        if self.ranges is not None:
            rf, nvtx = self.ranges
            rf.__exit__(*exc)
            if nvtx:
                torch.cuda.nvtx.range_pop()
        end = now_ns()
        _local.stack.pop()
        span = Span(self.name, self.start, end, threading.get_ident(), self.parent,
                    getattr(_local, "clip", None),
                    {k: _plain(v) for k, v in self.attrs.items()}, self.id)
        with _lock:
            _spans.append(span)
        return False


def annotate(name: str, **attrs):
    """A span named ``name`` around the enclosed block, with ``attrs``
    (a tensor or array recorded as its shape). A no-op unless recording."""
    if not _recording:
        return _NOOP
    return _Span(name, attrs)


def count(name: str, n) -> None:
    """Add ``n`` to the counter ``name`` (kept with its time and clip). A
    no-op unless recording."""
    if not _recording:
        return
    c = Counter(name, now_ns(), int(n), threading.get_ident(), getattr(_local, "clip", None))
    with _lock:
        _counters.append(c)


class _Clip:
    __slots__ = ("prev",)

    def __enter__(self):
        self.prev = getattr(_local, "clip", None)
        _local.clip = next(_clip_ids)
        return _local.clip

    def __exit__(self, *exc):
        _local.clip = self.prev
        return False


def clip():
    """A scope whose spans and counters carry a new clip id (on this thread,
    and on the threads started inside it through ``carry``). A no-op unless
    recording."""
    if not _recording:
        return _NOOP
    return _Clip()


def carry(target):
    """``target`` for a thread started now: it runs under the starting
    thread's clip id."""
    cid = getattr(_local, "clip", None)
    if cid is None:
        return target

    def run(*args, **kw):
        _local.clip = cid
        return target(*args, **kw)

    return run


@contextlib.contextmanager
def trace_context(trace_dir: Optional[str] = None) -> Iterator[Optional[str]]:
    """Profile the enclosed block when a trace dir is given (or
    ``VSE_TRACE_DIR`` is set), with the CPU and, where CUDA is available,
    the CUDA activities, recording spans meanwhile (each also a
    ``record_function`` and an NVTX range); no-op otherwise. On exit the
    Chrome trace is written to ``<trace_dir>/trace_<pid>_<ns>.json``; the
    context yields that path (None when inactive)."""
    global _profiled
    trace_dir = trace_dir or os.environ.get("VSE_TRACE_DIR")
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    was = _recording
    prof.start()
    record(True)
    _profiled = True
    try:
        yield path
    finally:
        _profiled = False
        record(was)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)
