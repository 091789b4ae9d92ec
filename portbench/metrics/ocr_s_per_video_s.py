"""Wall seconds of the extractor's ocr pass (``pass_seconds["ocr"]``) per
second of video completed."""


def read(r):
    s = r["passes"].get("ocr")
    return s / r["video_s"] if r["video_s"] and s else None
