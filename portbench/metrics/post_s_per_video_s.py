"""Wall seconds of the extractor's post pass (``pass_seconds["post"]``) per
second of video completed."""


def read(r):
    s = r["passes"].get("post")
    return s / r["video_s"] if r["video_s"] and s else None
