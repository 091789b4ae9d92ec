"""Seconds the frame stream's reader thread and the keyframe sample reads
spent decoding, per second of video completed (the ``decode`` spans)."""


def read(r):
    s = r["span_total"]("decode")
    return s / r["video_s"] if r["video_s"] and s else None
