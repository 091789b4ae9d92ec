"""Seconds in ``DetSpanTracker.feed`` and ``finish`` (the ``tracker``
spans) per second of video completed."""


def read(r):
    s = r["span_total"]("tracker")
    return s / r["video_s"] if r["video_s"] and s else None
