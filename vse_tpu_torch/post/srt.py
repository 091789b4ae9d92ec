"""Minimal SRT model and writer (the parts of the JAX package's module that
the port's main path uses). Times are integer milliseconds; formatting is
HH:MM:SS,mmm.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional


def ms_to_timestamp(ms: int) -> str:
    ms = max(0, int(ms))
    h, rem = divmod(ms, 3600_000)
    m, rem = divmod(rem, 60_000)
    s, milli = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d},{milli:03d}"


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

    def dumps(self) -> str:
        return "\n".join(item.format() for item in self.items)

    def save(self, path: str, encoding: str = "utf-8") -> None:
        with open(path, "w", encoding=encoding) as f:
            f.write(self.dumps())
