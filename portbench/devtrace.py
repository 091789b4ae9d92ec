"""Reductions of a traced run's profiler slice: the device's busy time,
its idle gaps named by the host span they fell in, the device ops with the
most time, and a kernel's launches matched to their device records.

A kernel's launches are counted only where they have device records: the
profiler drops some records in a long-running process, and a share that
summed device time over host launches would read high. A device record is
tied to its launch through the CUDA launch call's correlation id, and the
launch to the span around it by time.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


def window(profile: dict) -> Optional[Tuple[int, int]]:
    """The slice: the span of the clip the profiler covered (ns)."""
    clips = [(a, b) for n, a, b in profile["notes"] if n.startswith("clip#")]
    return clips[0] if clips else None


def merged_busy(profile: dict) -> List[Tuple[int, int]]:
    """Device-op intervals inside the slice, merged."""
    w = window(profile)
    if w is None:
        return []
    iv = sorted((max(a, w[0]), min(b, w[1])) for _, a, b, _ in profile["device"]
                if b > w[0] and a < w[1])
    out: List[List[int]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_and_window_s(profile: dict) -> Optional[Tuple[float, float]]:
    w = window(profile)
    if w is None:
        return None
    return sum(b - a for a, b in merged_busy(profile)) / 1e9, (w[1] - w[0]) / 1e9


def kernel_name(name: str) -> str:
    """A device op's name without its return type, template arguments and
    parameter list."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:120] or name[:120]


def _base(note: str) -> str:
    return note.split("#", 1)[0]


def breakdown(profile: dict, top: int = 10) -> dict:
    """``device_ops``: [name, seconds] of the ops with the most device time
    in the slice; ``idle_gaps``: [span, seconds] of the longest gaps between
    device work, each named by the innermost benchmark span that held the
    host at the gap's middle."""
    w = window(profile)
    if w is None:
        return {"device_ops": [], "idle_gaps": []}
    per = defaultdict(float)
    for name, a, b, _ in profile["device"]:
        if b > w[0] and a < w[1]:
            per[kernel_name(name)] += (min(b, w[1]) - max(a, w[0])) / 1e9
    ops = sorted(per.items(), key=lambda t: -t[1])[:top]
    busy = merged_busy(profile)
    edges = [w[0]] + [x for iv in busy for x in iv] + [w[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    notes = [(n, a, b) for n, a, b in profile["notes"] if not n.startswith("clip#")]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) // 2
        inside = [(na, n) for n, na, nb in notes if na <= mid <= nb]
        named.append([_base(max(inside)[1]) if inside else "host outside the spans",
                      (b - a) / 1e9])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def launches_with_records(profile: dict, span: str, kernel_re: str
                          ) -> Dict[int, Tuple[float, int]]:
    """(device seconds, records) of each launch (by span uid) of the span
    ``span`` that has device records matched by ``kernel_re`` and tied to
    it through their correlation ids."""
    launch_at = dict(profile["launches"])
    notes = sorted((a, b, int(n.split("#")[1])) for n, a, b in profile["notes"]
                   if _base(n) == span)
    starts = [a for a, _, _ in notes]
    dev_s: Dict[int, float] = defaultdict(float)
    count: Dict[int, int] = defaultdict(int)
    pat = re.compile(kernel_re)
    for name, a, b, corr in profile["device"]:
        if not pat.search(name) or corr not in launch_at:
            continue
        t = launch_at[corr]
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or not notes[i][0] <= t <= notes[i][1]:
            continue
        uid = notes[i][2]
        dev_s[uid] += (b - a) / 1e9
        count[uid] += 1
    return {uid: (s, count[uid]) for uid, s in dev_s.items()}
