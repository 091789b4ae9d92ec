"""Reads of the program's own recorder (``vse_tpu_torch.utils.tracing``),
which ``spans/program.py`` switches on in a traced run.

The recorder stamps its spans on the profiler's clock (Unix-epoch ns), so
they lie against the profiled clip's window and device records as they
are. Each read returns None where the program has no recorder or recorded
nothing of what is asked for."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import devtrace


def _recorder():
    from vse_tpu_torch.utils import tracing

    return tracing if hasattr(tracing, "spans") and hasattr(tracing, "counters") else None


def program_spans() -> Optional[list]:
    t = _recorder()
    return t.spans() if t is not None else None


def program_counters() -> Optional[list]:
    t = _recorder()
    return t.counters() if t is not None else None


def seconds_per_video_s(r: dict, names: Iterable[str]) -> Optional[float]:
    """Summed seconds of the spans named ``names`` (any thread) per second of
    video, leaving out the spans that overlap the profiled clip."""
    spans = program_spans()
    names = set(names)
    picked = [s for s in spans or () if s.name in names]
    if not picked or not r["video_s"]:
        return None
    w = devtrace.window(r["profile"])
    if w is not None:
        picked = [s for s in picked if s.end_ns <= w[0] or s.start_ns >= w[1]]
    return sum(s.end_ns - s.start_ns for s in picked) / 1e9 / r["video_s"]


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap_ns(xs: List[Tuple[int, int]], ys: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two merged, sorted interval lists."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_pct(r: dict, names: Iterable[str]) -> Optional[float]:
    """Share of the profiled clip's wall time in which the device ran no op
    (the complement of ``devtrace.merged_busy``) while the thread of the
    clip's ``extract`` span was inside a span named ``names``."""
    w = devtrace.window(r["profile"])
    spans = program_spans()
    if w is None or not spans or w[1] <= w[0]:
        return None
    roots = [s for s in spans if s.name == "extract" and s.start_ns < w[1] and s.end_ns > w[0]]
    if not roots:
        return None
    root = max(roots, key=lambda s: min(s.end_ns, w[1]) - max(s.start_ns, w[0]))
    names = set(names)
    held = _merge([(max(s.start_ns, w[0]), min(s.end_ns, w[1])) for s in spans
                   if s.thread == root.thread and s.name in names
                   and s.start_ns < w[1] and s.end_ns > w[0]])
    if not held:
        return None
    edges = [w[0]] + [x for iv in devtrace.merged_busy(r["profile"]) for x in iv] + [w[1]]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    return 100.0 * _overlap_ns(held, idle) / (w[1] - w[0])


def counter_sum(name: str) -> Optional[int]:
    got = [c.n for c in program_counters() or () if c.name == name]
    return sum(got) if got else None
