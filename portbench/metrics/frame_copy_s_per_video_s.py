"""Seconds of the frame path's host copies per second of video completed,
the profiled clip left out: the decode thread's contiguous RGB copy
(``decode.copy``), the batch assembly's zero-fill and copies
(``stream.assemble``) and the feeder's copy into pinned memory
(``feed.stage``), summed over their threads."""

import recorder


def read(r):
    return recorder.seconds_per_video_s(r, ["decode.copy", "stream.assemble", "feed.stage"])
