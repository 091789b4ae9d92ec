"""Seconds the extractor's thread spent blocked on the next uploaded frame
batch (the program's ``feed.wait`` spans, ``pipeline/feed.py``) per second
of video completed, the profiled clip left out."""

import recorder


def read(r):
    return recorder.seconds_per_video_s(r, ["feed.wait"])
