"""Shared helpers for the audio re-timer (the port of ``vse_tpu/sync/common.py``;
reference backend/sushi/common.py)."""

from __future__ import annotations

import os


class SyncError(Exception):
    pass


def get_extension(path: str) -> str:
    return os.path.splitext(path)[1].lower()


def clip(value, lo, hi):
    return max(min(value, hi), lo)


def format_time(seconds: float) -> str:
    cs = round(seconds * 100)
    return "{0}:{1:02d}:{2:02d}.{3:02d}".format(
        int(cs // 360000), int((cs // 6000) % 60), int((cs // 100) % 60), int(cs % 100)
    )


def format_srt_time(seconds: float) -> str:
    ms = round(seconds * 1000)
    return "{0:02d}:{1:02d}:{2:02d},{3:03d}".format(
        int(ms // 3600000), int((ms // 60000) % 60), int((ms // 1000) % 60), int(ms % 1000)
    )
