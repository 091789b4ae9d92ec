"""torch.profiler integration (the port of ``vse_tpu/utils/tracing.py``).

Wrap any pipeline section in ``trace_context`` to capture a profile of the
host and the card, written as a Chrome trace (``chrome://tracing``,
Perfetto); ``annotate`` names a sub-span inside it. Neither is called on
the main path, as in the JAX package.

The profiler can drop a kernel's device record (its log counts it as
"Out-of-range": outside the capture window once the device's timestamps
are converted to the host clock), more often in a process that has run for
minutes; the host-side launch record stays. Count launches from those
(``chip_smoke.py`` phase 13 does, in a span around each launch).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace_context(trace_dir: Optional[str] = None) -> Iterator[Optional[str]]:
    """Profile the enclosed block when a trace dir is given (or
    ``VSE_TRACE_DIR`` is set), with the CPU and, where CUDA is available,
    the CUDA activities; no-op otherwise. On exit the Chrome trace is
    written to ``<trace_dir>/trace_<pid>_<ns>.json``; the context yields
    that path (None when inactive)."""
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
    prof.start()
    try:
        yield path
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named sub-span inside a trace (``torch.profiler.record_function``);
    on a machine with CUDA also an NVTX range, which device-side tools
    show."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
