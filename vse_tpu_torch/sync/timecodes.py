"""Frame timecodes (CFR + VFR v1/v2), keyframe logs, and chapters (the port
of ``vse_tpu/sync/timecodes.py``, plain Python).

Rebuilds the reference's Timecodes model (reference backend/sushi/demux.py:
138-227), SCXviD keyframe log parsing (reference backend/sushi/keyframes.py:
1-15) and XML/OGM chapter parsing (reference backend/sushi/chapters.py:1-36).
"""

from __future__ import annotations

import bisect
import re
from typing import List, Optional

from vse_tpu_torch.sync.common import SyncError


class Timecodes:
    """Maps frame index <-> time, supporting variable frame rates."""

    def __init__(self, times: List[float], default_frame_duration: Optional[float]):
        super().__init__()
        self.times = times
        self.default_frame_duration = default_frame_duration

    def get_frame_time(self, number: int) -> float:
        if number < len(self.times):
            return self.times[number]
        if self.default_frame_duration is None:
            raise SyncError("frame number out of timecodes range")
        base = self.times[-1] if self.times else 0.0
        over = number - (len(self.times) - 1 if self.times else 0)
        return base + over * self.default_frame_duration

    def get_frame_number(self, timestamp: float) -> int:
        if self.times and timestamp <= self.times[-1]:
            return max(0, bisect.bisect_right(self.times, timestamp) - 1)
        if self.default_frame_duration is None:
            raise SyncError("timestamp out of timecodes range")
        base = self.times[-1] if self.times else 0.0
        n_base = len(self.times) - 1 if self.times else 0
        return n_base + int((timestamp - base) / self.default_frame_duration)

    def get_frame_size(self, timestamp: float) -> float:
        """Duration of the frame containing `timestamp`."""
        if self.times and timestamp <= self.times[-1]:
            i = self.get_frame_number(timestamp)
            if i + 1 < len(self.times):
                return self.times[i + 1] - self.times[i]
        if self.default_frame_duration is not None:
            return self.default_frame_duration
        if len(self.times) >= 2:
            return self.times[-1] - self.times[-2]
        raise SyncError("cannot infer frame size")

    @classmethod
    def cfr(cls, fps: float) -> "Timecodes":
        return cls([], 1.0 / fps)

    @classmethod
    def parse(cls, text: str) -> "Timecodes":
        lines = [l.strip() for l in text.splitlines() if l.strip()]
        if not lines:
            raise SyncError("empty timecodes file")
        header = lines[0].lower()
        if "format v2" in header:
            times = [float(x) / 1000.0 for x in lines[1:] if not x.startswith("#")]
            default = times[-1] - times[-2] if len(times) >= 2 else None
            return cls(times, default)
        if "format v1" in header:
            # "# timecode format v1" / "Assume <fps>" / "start,end,fps" overrides
            default_fps = None
            overrides = []
            for line in lines[1:]:
                if line.lower().startswith("assume"):
                    default_fps = float(line.split()[-1].replace(",", "."))
                elif "," in line:
                    a, b, fps = line.split(",")
                    overrides.append((int(a), int(b), float(fps)))
            if default_fps is None:
                raise SyncError("v1 timecodes without Assume line")
            times: List[float] = []
            t = 0.0
            frame = 0
            for start, end, fps in sorted(overrides):
                while frame < start:
                    times.append(t)
                    t += 1.0 / default_fps
                    frame += 1
                while frame <= end:
                    times.append(t)
                    t += 1.0 / fps
                    frame += 1
            return cls(times, 1.0 / default_fps)
        raise SyncError(f"unknown timecodes format: {lines[0]!r}")

    @classmethod
    def from_file(cls, path: str) -> "Timecodes":
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            return cls.parse(f.read())


def parse_scxvid_keyframes(text: str) -> List[int]:
    """SCXviD log: frame type letter in column 0 of stats lines; 'i' = keyframe
    (reference backend/sushi/keyframes.py)."""
    return [i - 3 for i, line in enumerate(text.splitlines()) if line and line[0] == "i"]


def parse_keyframes(path: str) -> List[int]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        text = f.read()
    if "# XviD 2pass stat file" in text:
        frames = parse_scxvid_keyframes(text)
    else:
        frames = [int(m.group(1)) for m in re.finditer(r"(\d+)", text)]
    if not frames:
        raise SyncError(f"no keyframes found in {path}")
    return frames


# --- chapters ----------------------------------------------------------------

def _parse_chapter_time(s: str) -> float:
    h, m, sec = s.split(":")
    return int(h) * 3600 + int(m) * 60 + float(sec.replace(",", "."))


def get_xml_start_times(path: str) -> List[float]:
    import xml.etree.ElementTree as ET

    tree = ET.parse(path)
    times = [
        _parse_chapter_time(el.text)
        for el in tree.getroot().iter("ChapterTimeStart")
    ]
    return sorted(times)


def get_ogm_start_times(path: str) -> List[float]:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        text = f.read()
    times = [
        _parse_chapter_time(m.group(1))
        for m in re.finditer(r"^CHAPTER\d+\s*=\s*(\d+:\d+:\d+[,.]\d+)",
                             text, flags=re.M | re.I)
    ]
    return sorted(t for t in times)
