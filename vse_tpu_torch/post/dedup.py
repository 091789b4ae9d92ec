"""Subtitle dedup + SRT generation (the port of the JAX package's module).

Semantics-parity re-implementation of the reference's dedup/SRT stage:

- `remove_duplicate_subtitles` (reference backend/main.py:774-818): scan
  consecutive raw lines; a span ends when the *next* line's space-stripped
  text falls below `threshold_text_similarity/100` Levenshtein ratio against
  the span head (or at EOF); the kept text is the *longest* space-stripped
  variant in the span; single-frame spans extend to the next line's start
  frame (non-keyframe-timeline mode only).
- `generate_srt` (reference backend/main.py:614-637): cues shorter than 1s
  (|end-start| < fps) are padded to exactly 1s; timestamps come from a
  frame->ms mapping.
- `generate_srt_from_timeline` (reference backend/main.py:639-669): merge a
  keyframe-scanner timeline SRT with deduped OCR text — cue start frames are
  matched to span starts, end times re-linked to the matched span end's cue,
  and unmatched cues kept as empty-text cues unless `delete_empty_timestamp`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

from vse_tpu_torch.ops.levenshtein import ratio
from vse_tpu_torch.post.records import RawRecord, concat_same_frame
from vse_tpu_torch.post.srt import SrtFile, SrtItem


Span = Tuple[int, int, str]  # (start_frame, end_frame, text)


def remove_duplicate_subtitles(
    records: List[RawRecord],
    threshold_percent: int = 80,
    single_frame_extends: bool = True,
) -> List[Span]:
    """Group consecutive similar lines into spans (reference
    backend/main.py:774-818)."""
    records = concat_same_frame(records)
    spans: List[Span] = []
    n = len(records)
    i = 0
    thr = threshold_percent / 100.0
    while i < n:
        head = records[i]
        head_strip = head.text.replace(" ", "")
        j = i
        while j < n:
            is_last = j + 1 == n
            if is_last or ratio(
                head_strip, records[j + 1].text.replace(" ", "")
            ) < thr:
                end_frame = records[j].frame_no
                if single_frame_extends:
                    if end_frame == head.frame_no and j + 1 < n:
                        # single-frame span: borrow the next line's start
                        end_frame = records[j + 1].frame_no
                # keep the longest (space-stripped) variant in the span
                group = records[i : j + 1]
                best = max(
                    range(len(group)),
                    key=lambda k: len(group[k].text.replace(" ", "")),
                )
                spans.append((head.frame_no, end_frame, group[best].text))
                i = j + 1
                break
            j += 1
    return spans


def generate_srt(
    spans: Sequence[Span],
    frame_to_ms: Callable[[int], float],
    fps: float,
) -> Tuple[SrtFile, List[int]]:
    """Spans -> SRT with the reference's <1s padding rule (reference
    backend/main.py:614-637). Returns (srt, indices_padded)."""
    srt = SrtFile()
    padded: List[int] = []
    for idx, (start_f, end_f, text) in enumerate(spans):
        line_code = idx + 1
        start_ms = int(frame_to_ms(int(start_f)))
        if abs(int(end_f) - int(start_f)) < fps:
            end_ms = int(frame_to_ms(int(int(start_f) + fps)))
            padded.append(line_code)
        else:
            end_ms = int(frame_to_ms(int(end_f)))
        srt.append(SrtItem(line_code, start_ms, end_ms, text.rstrip("\n")))
    return srt, padded


def generate_srt_from_timeline(
    timeline: SrtFile,
    spans: Sequence[Span],
    ms_to_frameno: Callable[[int], int],
    delete_empty_timestamp: bool = True,
) -> SrtFile:
    """Merge a keyframe-scanner timeline with deduped OCR spans (reference
    backend/main.py:639-669)."""
    sub_no_map: Dict[int, SrtItem] = {}
    start_nos: List[int] = []
    for item in timeline:
        no = ms_to_frameno(item.start_ms)
        start_nos.append(no)
        sub_no_map[no] = item

    span_by_start = {int(s[0]): s for s in spans}
    out = SrtFile()
    for item, no in zip(timeline, start_nos):
        if no in span_by_start:
            start_f, end_f, text = span_by_start[no]
            end_item = sub_no_map.get(int(end_f))
            out.append(
                SrtItem(
                    index=len(out) + 1,
                    start_ms=item.start_ms,
                    end_ms=end_item.end_ms if end_item is not None else item.end_ms,
                    text=text.rstrip("\n"),
                )
            )
        elif not delete_empty_timestamp:
            out.append(
                SrtItem(
                    index=len(out) + 1,
                    start_ms=item.start_ms,
                    end_ms=item.end_ms,
                    text="",
                )
            )
    return out
