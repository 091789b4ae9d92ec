"""Spans around calls into the program, recorded from the benchmark's own
files, and the profiler slice of a traced run.

A layer's file under ``spans/`` names the functions of the program that
the traced run wraps (``WRAPS``: ``(module, attribute, span name)``,
``attribute`` dotted for a method of a class) and the layer they belong
to. A span records its name, start, end, thread and, where the span file
asks for it, the shapes of the call's tensor arguments. Spans are kept in
memory; inside the profiler slice each one is also a
``torch.profiler.record_function`` range, so that the device's idle gaps
can be named by the span the host was in.
"""

from __future__ import annotations

import functools
import itertools
import glob
import importlib
import importlib.util
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load_file(path: str, prefix: str):
    """A module of the benchmark loaded from its file path."""
    name = f"portbench_{prefix}_{os.path.splitext(os.path.basename(path))[0]}".replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shapes(args) -> tuple:
    return tuple(tuple(a.shape) for a in args if hasattr(a, "shape"))


class Tracer:
    def __init__(self):
        self.spans: List[tuple] = []  # (name, t0, t1, thread, shapes, uid)
        self._uid = itertools.count()
        self.profiling = False
        self._undo: List[Callable[[], None]] = []
        self._lock = threading.Lock()
        self.layers: Dict[str, str] = {}

    def _record(self, name, t0, t1, shapes, uid=-1):
        with self._lock:
            self.spans.append((name, t0, t1, threading.get_ident(), shapes, uid))

    def wrap(self, owner, attr: str, name: str, shapes: bool = False) -> None:
        orig = getattr(owner, attr)
        tracer = self
        if getattr(orig, "__code__", None) is not None and orig.__code__.co_flags & 0x20:
            @functools.wraps(orig)
            def gen(*args, **kw):  # a generator: each step is a span
                it = orig(*args, **kw)
                try:
                    while True:
                        t0 = time.perf_counter()
                        try:
                            item = next(it)
                        except StopIteration:
                            return
                        tracer._record(name, t0, time.perf_counter(), ())
                        yield item
                finally:
                    it.close()
            new = gen
        else:
            @functools.wraps(orig)
            def call(*args, **kw):
                uid = next(tracer._uid)
                if tracer.profiling:
                    with torch.profiler.record_function(f"portbench.{name}#{uid}"):
                        t0 = time.perf_counter()
                        out = orig(*args, **kw)
                else:
                    t0 = time.perf_counter()
                    out = orig(*args, **kw)
                tracer._record(name, t0, time.perf_counter(),
                               _shapes(args) if shapes else (), uid)
                return out
            new = call
        setattr(owner, attr, new)
        self._undo.append(lambda: setattr(owner, attr, orig))

    def install(self, paths: Optional[List[str]] = None) -> None:
        """Wrap what every span file under ``spans/`` names."""
        for path in paths or sorted(glob.glob(os.path.join(HERE, "spans", "*.py"))):
            mod = load_file(path, "spans")
            for module, attr, name, *opt in mod.WRAPS:
                owner = importlib.import_module(module)
                *outer, last = attr.split(".")
                for part in outer:
                    owner = getattr(owner, part)
                self.wrap(owner, last, name, shapes=bool(opt and opt[0]))
                self.layers[name] = mod.LAYER

    def uninstall(self) -> None:
        for undo in reversed(self._undo):
            undo()
        self._undo.clear()


def profile_record(prof) -> dict:
    """The device records and host annotations of a profiler run: device
    ops ``(name, start_ns, end_ns, correlation)``, host launch calls
    ``(correlation, start_ns)`` and the benchmark's annotations
    ``(name, start_ns, end_ns)``."""
    dev, launches, notes = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith("portbench."):  # an annotation's copy on the device timeline
                continue
            corr = e.linked_correlation_id() or e.correlation_id()
            dev.append((name, e.start_ns(), e.start_ns() + e.duration_ns(), corr))
        elif name.startswith("portbench."):
            notes.append((name[len("portbench."):], e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch")):
            launches.append((e.correlation_id(), e.start_ns()))
    return {"device": dev, "launches": launches, "notes": notes}
