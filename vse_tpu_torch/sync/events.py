"""Subtitle event model + SRT/ASS script parsing for the re-timer (the port
of ``vse_tpu/sync/events.py``, plain Python).

Re-implements the reference's script model (reference backend/sushi/subs.py:
15-275): events carry a shift + per-edge micro-shifts and can be *linked* to
another event whose shift they inherit (comments, zero-duration lines,
duplicates). Parsers cover SRT and ASS (events + arbitrary sections)."""

from __future__ import annotations

import re
from typing import List, Optional

from vse_tpu_torch.sync.common import SyncError, format_srt_time


class Event:
    """One subtitle event; times in float seconds."""

    is_comment = False
    style: Optional[str] = None

    def __init__(self, source_index: int, start: float, end: float, text: str):
        self.source_index = source_index
        self.start = start
        self.end = end
        self.text = text
        self._shift = 0.0
        self._diff = 1.0
        self._link: Optional["Event"] = None
        self._start_shift = 0.0
        self._end_shift = 0.0

    # --- shift/link algebra (reference subs.py:28-80) ----------------------
    @property
    def shift(self) -> float:
        return self._link.shift if self._link is not None else self._shift

    @property
    def diff(self) -> float:
        return self._link.diff if self._link is not None else self._diff

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def shifted_start(self) -> float:
        return self.start + self.shift + self._start_shift

    @property
    def shifted_end(self) -> float:
        return self.end + self.shift + self._end_shift

    @property
    def linked(self) -> bool:
        return self._link is not None

    def set_shift(self, shift: float, audio_diff: float) -> None:
        assert not self.linked
        self._shift = shift
        self._diff = audio_diff

    def adjust_shift(self, value: float) -> None:
        assert not self.linked
        self._shift += value

    def adjust_additional_shifts(self, start_shift: float, end_shift: float) -> None:
        assert not self.linked
        self._start_shift += start_shift
        self._end_shift += end_shift

    def link_event(self, other: "Event") -> None:
        assert other.get_link_chain_end() is not self, "circular link"
        self._link = other

    def get_link_chain_end(self) -> "Event":
        return self._link.get_link_chain_end() if self._link is not None else self

    def resolve_link(self) -> None:
        assert self.linked
        self._shift = self._link.shift
        self._diff = self._link.diff
        self._link = None

    def apply_shift(self) -> None:
        self.start = self.shifted_start
        self.end = self.shifted_end


class Script:
    def __init__(self, events: List[Event]):
        self.events = events

    def sort_by_time(self) -> None:
        self.events.sort(key=lambda e: e.start)

    def save_to_file(self, path: str) -> None:
        raise NotImplementedError


# --- SRT ---------------------------------------------------------------------

_SRT_TIME = re.compile(r"(\d{1,2}):(\d{1,2}):(\d{1,2})[,.](\d+)")
_SRT_BLOCK = re.compile(
    r"(\d+)\s+(\d{1,2}:\d{1,2}:\d{1,2}[,.]\d+)\s*-->\s*(\d{1,2}:\d{1,2}:\d{1,2}[,.]\d+)"
)


def _parse_srt_time(s: str) -> float:
    m = _SRT_TIME.search(s)
    h, mi, sec, frac = m.groups()
    ms = int(frac.ljust(3, "0")[:3])
    return int(h) * 3600 + int(mi) * 60 + int(sec) + ms / 1000.0


class SrtScript(Script):
    @classmethod
    def from_file(cls, path: str) -> "SrtScript":
        try:
            with open(path, "r", encoding="utf-8-sig", errors="replace") as f:
                text = f.read()
        except OSError:
            raise SyncError(f"Script {path} not found")
        events = []
        matches = list(_SRT_BLOCK.finditer(text))
        for i, m in enumerate(matches):
            body_end = matches[i + 1].start() if i + 1 < len(matches) else len(text)
            body = text[m.end() : body_end].strip()
            events.append(
                Event(int(m.group(1)), _parse_srt_time(m.group(2)),
                      _parse_srt_time(m.group(3)), body)
            )
        return cls(events)

    def save_to_file(self, path: str) -> None:
        blocks = []
        for i, e in enumerate(self.events):
            blocks.append(
                f"{i + 1}\n{format_srt_time(e.start)} --> "
                f"{format_srt_time(e.end)}\n{e.text}"
            )
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n\n".join(blocks) + "\n")


# --- ASS ---------------------------------------------------------------------

def _parse_ass_time(s: str) -> float:
    h, m, sec = s.split(":")
    return int(h) * 3600 + int(m) * 60 + float(sec)


def _format_ass_time(seconds: float) -> str:
    cs = round(seconds * 100)
    return "{0}:{1:02d}:{2:02d}.{3:02d}".format(
        int(cs // 360000), int((cs // 6000) % 60), int((cs // 100) % 60), int(cs % 100)
    )


class AssEvent(Event):
    def __init__(self, source_index: int, kind: str, fields: List[str],
                 format_names: List[str]):
        self.kind = kind  # "Dialogue" or "Comment"
        self.fields = fields
        self._fmt = format_names
        start = _parse_ass_time(fields[format_names.index("Start")])
        end = _parse_ass_time(fields[format_names.index("End")])
        text = fields[format_names.index("Text")]
        super().__init__(source_index, start, end, text)
        self.is_comment = kind.lower() == "comment"
        if "Style" in format_names:
            self.style = fields[format_names.index("Style")]

    def format_line(self) -> str:
        fields = list(self.fields)
        fields[self._fmt.index("Start")] = _format_ass_time(self.start)
        fields[self._fmt.index("End")] = _format_ass_time(self.end)
        return f"{self.kind}: " + ",".join(fields)


class AssScript(Script):
    def __init__(self, events: List[Event], sections: List[tuple],
                 format_names: List[str]):
        super().__init__(events)
        self.sections = sections  # [(name, [raw lines])] excluding [Events]
        self.format_names = format_names

    @classmethod
    def from_file(cls, path: str) -> "AssScript":
        try:
            with open(path, "r", encoding="utf-8-sig", errors="replace") as f:
                lines = f.read().splitlines()
        except OSError:
            raise SyncError(f"Script {path} not found")
        sections: List[tuple] = []
        events: List[Event] = []
        fmt: List[str] = []
        current: Optional[str] = None
        in_events = False
        idx = 0
        for line in lines:
            stripped = line.strip()
            if stripped.startswith("[") and stripped.endswith("]"):
                current = stripped
                in_events = stripped.lower() == "[events]"
                if not in_events:
                    sections.append((current, []))
                continue
            if current is None:
                continue
            if in_events:
                if stripped.lower().startswith("format:"):
                    fmt = [x.strip() for x in stripped[7:].split(",")]
                elif ":" in stripped and stripped:
                    kind, _, rest = stripped.partition(":")
                    kind = kind.strip()
                    if kind in ("Dialogue", "Comment"):
                        fields = rest.lstrip().split(",", len(fmt) - 1)
                        events.append(AssEvent(idx, kind, fields, fmt))
                        idx += 1
            else:
                sections[-1][1].append(line)
        if not fmt:
            raise SyncError(f"{path}: no [Events] Format line")
        return cls(events, sections, fmt)

    def save_to_file(self, path: str) -> None:
        out = []
        for name, body in self.sections:
            out.append(name)
            out.extend(body)
        out.append("[Events]")
        out.append("Format: " + ", ".join(self.format_names))
        for e in self.events:
            out.append(e.format_line())
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(out) + "\n")
