"""Wall seconds of the extractor's scan pass (``pass_seconds["scan"]``) per
second of video completed."""


def read(r):
    s = r["passes"].get("scan")
    return s / r["video_s"] if r["video_s"] and s else None
