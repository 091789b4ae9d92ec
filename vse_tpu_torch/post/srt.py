"""Minimal SRT model, parser and writer (the port of the JAX package's
module). Times are integer milliseconds; formatting is HH:MM:SS,mmm.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Iterator, List, Optional


def ms_to_timestamp(ms: int) -> str:
    ms = max(0, int(ms))
    h, rem = divmod(ms, 3600_000)
    m, rem = divmod(rem, 60_000)
    s, milli = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d},{milli:03d}"


_TS_RE = re.compile(r"(\d+):(\d+):(\d+)[,.](\d+)")


def timestamp_to_ms(ts: str) -> int:
    m = _TS_RE.search(ts)
    if not m:
        raise ValueError(f"bad SRT timestamp: {ts!r}")
    h, mi, s, milli = (int(g) for g in m.groups())
    return ((h * 60 + mi) * 60 + s) * 1000 + milli


@dataclass
class SrtItem:
    index: int
    start_ms: int
    end_ms: int
    text: str

    def format(self) -> str:
        return (
            f"{self.index}\n"
            f"{ms_to_timestamp(self.start_ms)} --> {ms_to_timestamp(self.end_ms)}\n"
            f"{self.text}\n"
        )


class SrtFile:
    """A list of SrtItems."""

    def __init__(self, items: Optional[List[SrtItem]] = None):
        self.items: List[SrtItem] = items or []

    def __iter__(self) -> Iterator[SrtItem]:
        return iter(self.items)

    def __len__(self) -> int:
        return len(self.items)

    def append(self, item: SrtItem) -> None:
        self.items.append(item)

    def reindex(self) -> None:
        for i, item in enumerate(self.items):
            item.index = i + 1

    @classmethod
    def loads(cls, data: str) -> "SrtFile":
        """Parse SRT text: blocks split on blank lines, an optional numeric
        index line, a ``start --> end`` line, then the cue's text lines
        (a BOM and \\r\\n line ends are tolerated; blocks without a time
        line are skipped)."""
        items: List[SrtItem] = []
        data = data.lstrip("\ufeff")
        for block in re.split(r"\n\s*\n", data.strip(), flags=re.M):
            lines = [line.rstrip("\r") for line in block.strip().split("\n")]
            idx_line = 0
            index = len(items) + 1
            if re.fullmatch(r"\d+", lines[0].strip()):
                index = int(lines[0].strip())
                idx_line = 1
            if idx_line >= len(lines) or "-->" not in lines[idx_line]:
                continue
            start_s, _, end_s = lines[idx_line].partition("-->")
            items.append(SrtItem(
                index, timestamp_to_ms(start_s), timestamp_to_ms(end_s),
                "\n".join(lines[idx_line + 1 :]),
            ))
        return cls(items)

    @classmethod
    def open(cls, path: str, encoding: str = "utf-8") -> "SrtFile":
        with open(path, "r", encoding=encoding, errors="replace") as f:
            return cls.loads(f.read())

    def dumps(self) -> str:
        return "\n".join(item.format() for item in self.items)

    def save(self, path: str, encoding: str = "utf-8") -> None:
        with open(path, "w", encoding=encoding) as f:
            f.write(self.dumps())


def srt_to_txt(srt_path: str, txt_path: Optional[str] = None) -> str:
    """Write a plain-text transcript next to an SRT, one cue's text per line
    (reference backend/main.py:1037-1043). Returns its path."""
    subs = SrtFile.open(srt_path)
    if txt_path is None:
        txt_path = re.sub(r"\.srt$", ".txt", srt_path)
    with open(txt_path, "w", encoding="utf-8") as f:
        for item in subs:
            f.write(f"{item.text}\n")
    return txt_path
