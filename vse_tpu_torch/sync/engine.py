"""The audio re-timer engine ("Timeline Sync").

Behavior-parity rebuild of the reference's sushi core (reference
backend/sushi/__init__.py:29-489): group subtitle events, find each group's
audio offset in the destination track by windowed normalized-sqdiff template
matching (small -> normal -> max window escalation with rewind on consecutive
failures), then repair borders, median-smooth, average within stable groups,
and optionally snap to keyframes. The port of ``vse_tpu/sync/engine.py``,
unchanged: the matcher is ``vse_tpu_torch/sync/match.py`` (numpy by
default, ``torch.fft`` on the stream's device when asked); everything here
is host logic over a handful of floats per event.
"""

from __future__ import annotations

import bisect
import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from vse_tpu_torch.sync.common import SyncError, clip, format_time
from vse_tpu_torch.sync.events import Event
from vse_tpu_torch.sync.wav import WavStream

ALLOWED_ERROR = 0.01
MAX_GROUP_STD = 0.025

log = logging.getLogger("vse_tpu_torch.sync")


# --- statistics helpers ------------------------------------------------------

def interpolate_nones(data: Sequence[Optional[float]], points: Sequence[float]) -> List[float]:
    known = {p: v for p, v in zip(points, data) if v is not None}
    if not known:
        return []
    missing = sorted({p for p, v in zip(points, data) if v is None} - set(known))
    if missing:
        xs = sorted(known)
        interped = np.interp(missing, xs, [known[x] for x in xs])
        known.update(zip(missing, interped))
    return [known[p] if v is None else v for p, v in zip(points, data)]


def running_median(values: Sequence[float], window_size: int) -> List[float]:
    if window_size % 2 != 1:
        raise SyncError("median window size must be odd")
    half = window_size // 2
    n = len(values)
    out = []
    for i in range(n):
        r = min(half, i, n - i - 1)
        out.append(float(np.median(values[i - r : i + r + 1])))
    return out


def smooth_events(events: List[Event], radius: int) -> None:
    if not radius or not events:
        return
    smoothed = running_median([e.shift for e in events], radius * 2 + 1)
    for e, s in zip(events, smoothed):
        e.set_shift(s, e.diff)


# --- grouping ----------------------------------------------------------------

def detect_groups(events: Sequence[Event]) -> List[List[Event]]:
    """Split consecutive events whenever the shift jumps by > ALLOWED_ERROR."""
    it = iter(events)
    groups = [[next(it)]]
    for e in it:
        if abs(e.shift - groups[-1][-1].shift) > ALLOWED_ERROR:
            groups.append([])
        groups[-1].append(e)
    return groups


def groups_from_chapters(events: Sequence[Event], times: List[float]) -> List[List[Event]]:
    groups: List[List[Event]] = [[]]
    bounds = iter(times[1:] + [36000000000])
    cur = next(bounds)
    for e in events:
        if e.end > cur:
            groups.append([])
            while e.end > cur:
                cur = next(bounds)
        groups[-1].append(e)
    groups = [g for g in groups if g]
    # merge groups that contain only linked events into their parents
    broken = [g for g in groups if not any(not e.linked for e in g)]
    if broken:
        for g in broken:
            for e in g:
                parent = e.get_link_chain_end()
                pg = next(x for x in groups if parent in x)
                pg.append(e)
            g.clear()
        groups = [g for g in groups if g]
        for g in groups:
            g.sort(key=lambda e: e.start)
    return groups


def split_broken_groups(groups: List[List[Event]]) -> List[List[Event]]:
    correct: List[List[Event]] = []
    broken_found = False
    for g in groups:
        if float(np.std([e.shift for e in g])) > MAX_GROUP_STD:
            log.warning(
                "inconsistent shift %s-%s, regrouping automatically",
                format_time(g[0].start), format_time(g[-1].end),
            )
            correct.extend(detect_groups(g))
            broken_found = True
        else:
            correct.append(g)
    if broken_found:
        it = iter(correct)
        merged = [list(next(it))]
        for g in it:
            if (
                abs(merged[-1][-1].shift - g[0].shift) >= ALLOWED_ERROR
                or float(np.std([e.shift for e in g + merged[-1]])) >= MAX_GROUP_STD
            ):
                merged.append([])
            merged[-1].extend(g)
        correct = merged
    return correct


def fix_near_borders(events: List[Event]) -> None:
    """Relink boundary events whose audio diff is way off the median
    (reference __init__.py:152-178)."""

    def fix(ordered: List[Event], median_diff: float) -> int:
        first_ten = float(np.median([e.diff for e in ordered[:10]]))
        limit = min(first_ten, median_diff)
        broken: List[Event] = []
        for e in ordered:
            if not 0.2 < (e.diff / limit) < 5:
                broken.append(e)
            else:
                for b in broken:
                    b.link_event(e)
                return len(broken)
        return 0

    if not events:
        return
    median_diff = float(np.median([e.diff for e in events]))
    n = fix(events, median_diff)
    if n:
        log.info("fixed %d events at the start border", n)
    n = fix(list(reversed(events)), median_diff)
    if n:
        log.info("fixed %d events at the end border", n)


def average_shifts(events: List[Event]) -> float:
    free = [e for e in events if not e.linked]
    shifts = [e.shift for e in free]
    weights = [1 - e.diff for e in free]
    avg = float(np.average(shifts, weights=weights))
    for e in free:
        e.set_shift(avg, e.diff)
    return avg


def merge_short_lines_into_groups(
    events: Sequence[Event], chapter_times: List[float],
    max_ts_duration: float, max_ts_distance: float,
) -> List[List[Event]]:
    """Typesetting lines (short, clustered) search as one group
    (reference __init__.py:283-311)."""
    events = list(events)
    groups: List[List[Event]] = []
    bounds = iter(chapter_times[1:] + [100000000])
    next_chapter = next(bounds)
    processed = set()
    for i, e in enumerate(events):
        if i in processed:
            continue
        while e.end > next_chapter:
            next_chapter = next(bounds)
        if e.duration > max_ts_duration:
            groups.append([e])
            processed.add(i)
        else:
            group = [e]
            group_end = e.end
            j = i + 1
            while j < len(events) and abs(group_end - events[j].start) < max_ts_distance:
                if events[j].end < next_chapter and events[j].duration <= max_ts_duration:
                    processed.add(j)
                    group.append(events[j])
                    group_end = max(group_end, events[j].end)
                j += 1
            groups.append(group)
    return groups


def prepare_search_groups(
    events: List[Event], source_duration: float, chapter_times: List[float],
    max_ts_duration: float, max_ts_distance: float,
) -> List[List[Event]]:
    """Link comments/zero-duration/duplicate/out-of-range events, then build
    search groups (reference __init__.py:314-360)."""
    last_unlinked: Optional[Event] = None
    for i, e in enumerate(events):
        if e.is_comment:
            e.link_event(events[i + 1] if i + 1 < len(events) else last_unlinked)
            continue
        if (e.start + e.duration / 2.0) > source_duration:
            log.info("event at %s outside of audio range", format_time(e.start))
            e.link_event(last_unlinked)
            continue
        if e.end == e.start:
            e.link_event(events[i + 1] if i + 1 < len(events) else last_unlinked)
            continue
        # duplicates: identical start AND end to an earlier unlinked event
        dup = None
        for prior in reversed(events[:i]):
            if prior.start != e.start:
                break
            if not prior.linked and prior.end == e.end:
                dup = prior
                break
        if dup is not None:
            e.link_event(dup)
        else:
            last_unlinked = e

    free = (e for e in events if not e.linked)
    search_groups = merge_short_lines_into_groups(
        free, chapter_times, max_ts_duration, max_ts_distance
    )
    # groups fully inside another group link to it
    passed: List[List[Event]] = []
    for i, g in enumerate(search_groups):
        container = next(
            (
                x for x in reversed(search_groups[:i])
                if x[0].start <= g[0].start and x[-1].end >= g[-1].end
            ),
            None,
        )
        if container is not None:
            for e in g:
                e.link_event(container[0])
        else:
            passed.append(g)
    return passed


# --- the shift search --------------------------------------------------------

def calculate_shifts(
    src: WavStream, dst: WavStream, groups: List[List[Event]],
    normal_window: float, max_window: float, rewind_thresh: int,
) -> None:
    """Windowed escalating search (reference __init__.py:363-471): try a small
    window around the last committed shift; on failure search left/right
    template halves independently and require agreement; after
    `rewind_thresh` consecutive failures widen to max_window and rewind."""
    small_window = 1.5
    committed: List[Dict] = []
    uncommitted: List[Dict] = []
    window = normal_window
    idx = 0
    while idx < len(groups):
        g = groups[idx]
        pattern = src.get_substream(g[0].start, g[-1].end)
        t0 = g[0].start
        state = {"start": g[0].start, "end": g[-1].end, "shift": None, "diff": None}
        last_shift = committed[-1]["shift"] if committed else 0.0
        diff = new_time = None

        if not uncommitted:
            if t0 + last_shift > dst.duration_seconds:
                for rest in groups[idx:]:
                    committed.append(
                        {"start": rest[0].start, "end": rest[-1].end,
                         "shift": None, "diff": None}
                    )
                    log.info("%s-%s: outside of audio range",
                             format_time(rest[0].start), format_time(rest[-1].end))
                break
            if small_window < window:
                diff, new_time = dst.find_substream(pattern, t0 + last_shift, small_window)
            if new_time is not None and abs((new_time - t0) - last_shift) <= ALLOWED_ERROR:
                state.update({"shift": new_time - t0, "diff": diff})
                committed.append(state)
                if window != normal_window:
                    window = normal_window
                idx += 1
                continue

        half = len(pattern) // 2
        left, right = pattern[:half], pattern[half:]
        right_offset = half / float(src.sample_rate)
        terminate = False
        if t0 + last_shift < dst.duration_seconds:
            diff, new_time = dst.find_substream(pattern, t0 + last_shift, window)
            lt = dst.find_substream(left, t0 + last_shift, window)[1]
            rt = dst.find_substream(right, t0 + last_shift + right_offset, window)[1] - right_offset
            terminate = abs(lt - rt) <= ALLOWED_ERROR and abs(new_time - lt) <= ALLOWED_ERROR
        if (
            not terminate and uncommitted and uncommitted[-1]["shift"] is not None
            and t0 + uncommitted[-1]["shift"] < dst.duration_seconds
        ):
            off = uncommitted[-1]["shift"]
            diff, new_time = dst.find_substream(pattern, t0 + off, window)
            lt = dst.find_substream(left, t0 + off, window)[1]
            rt = dst.find_substream(right, t0 + off + right_offset, window)[1] - right_offset
            terminate = abs(lt - rt) <= ALLOWED_ERROR and abs(new_time - lt) <= ALLOWED_ERROR

        shift = (new_time - t0) if new_time is not None else None
        if not terminate:
            state.update({"shift": shift, "diff": diff})
            uncommitted.append(state)
            idx += 1
            if rewind_thresh == len(uncommitted) and window < max_window:
                log.warning(
                    "possibly broken segment at %s; widening window %s -> %s",
                    format_time(uncommitted[0]["start"]), window, max_window,
                )
                window = max_window
                idx = len(committed)
                uncommitted.clear()
            continue

        if uncommitted:
            log.warning(
                "events %s to %s will most likely be broken",
                format_time(uncommitted[0]["start"]),
                format_time(uncommitted[-1]["end"]),
            )
        uncommitted.append(state)
        for s in uncommitted:
            s.update({"shift": shift, "diff": diff})
        committed.extend(uncommitted)
        uncommitted.clear()
        idx += 1

    all_states = committed + uncommitted
    for i, (g, s) in enumerate(zip(groups, all_states)):
        if s["shift"] is None:
            for pg in reversed(groups[:i]):
                link_to = next((x for x in reversed(pg) if not x.linked), None)
                if link_to:
                    for e in g:
                        e.link_event(link_to)
                    break
        else:
            for e in g:
                e.set_shift(s["shift"], s["diff"])


# --- keyframe snapping ------------------------------------------------------

def distance_to_closest_kf(t: float, keytimes: List[float]) -> float:
    i = bisect.bisect_left(keytimes, t)
    if i == 0:
        kf = keytimes[0]
    elif i == len(keytimes):
        kf = keytimes[-1]
    else:
        before, after = keytimes[i - 1], keytimes[i]
        kf = after if after - t < t - before else before
    return kf - t


def find_keyframe_shift(group, src_kt, dst_kt, src_tc, dst_tc, max_kf_distance):
    def dist(src_d, dst_d, limit):
        if abs(dst_d) > limit:
            return None
        shift = dst_d - src_d
        return shift if abs(shift) < limit else None

    ss = distance_to_closest_kf(group[0].start, src_kt)
    se = distance_to_closest_kf(
        group[-1].end + src_tc.get_frame_size(group[-1].end), src_kt
    )
    ds = distance_to_closest_kf(group[0].shifted_start, dst_kt)
    de = distance_to_closest_kf(
        group[-1].shifted_end + dst_tc.get_frame_size(group[-1].end), dst_kt
    )
    lim_start = src_tc.get_frame_size(group[0].start) * max_kf_distance
    lim_end = src_tc.get_frame_size(group[0].end) * max_kf_distance
    return dist(ss, ds, lim_start), dist(se, de, lim_end)


def find_keyframes_distances(event, src_kt, dst_kt, timecodes, max_kf_distance):
    def one(src_t, dst_t):
        s = distance_to_closest_kf(src_t, src_kt)
        d = distance_to_closest_kf(dst_t, dst_kt)
        lim = timecodes.get_frame_size(src_t) * max_kf_distance
        if abs(s) < lim and abs(d) < lim and abs(s - d) < lim:
            return d - s
        return 0

    return one(event.start, event.shifted_start), one(event.end, event.shifted_end)


def snap_groups_to_keyframes(
    events, chapter_times, max_ts_duration, max_ts_distance,
    src_kt, dst_kt, src_tc, dst_tc, max_kf_distance, kf_mode,
):
    if not max_kf_distance:
        return
    groups = merge_short_lines_into_groups(
        events, chapter_times, max_ts_duration, max_ts_distance
    )
    if kf_mode in ("all", "shift"):
        shifts: List[Optional[float]] = []
        times: List[float] = []
        for g in groups:
            shifts.extend(
                find_keyframe_shift(g, src_kt, dst_kt, src_tc, dst_tc, max_kf_distance)
            )
            times.extend((g[0].shifted_start, g[-1].shifted_end))
        shifts = interpolate_nones(shifts, times)
        if shifts:
            mean_shift = float(np.mean(shifts))
            pairs = zip(*[iter(shifts)] * 2)
            for g, (s0, s1) in zip(groups, pairs):
                if abs(s0 - s1) > 0.001 and len(g) > 1:
                    actual = min(s0, s1, key=lambda x: abs(x - mean_shift))
                    for e in g:
                        e.adjust_shift(actual)
                else:
                    for e in g:
                        e.adjust_additional_shifts(s0, s1)
    if kf_mode in ("all", "snap"):
        for g in groups:
            s0, s1 = find_keyframes_distances(
                g[0], src_kt, dst_kt, src_tc, max_kf_distance
            )
            if abs(s0) > 0.01 or abs(s1) > 0.01:
                g[0].adjust_additional_shifts(s0, s1)
