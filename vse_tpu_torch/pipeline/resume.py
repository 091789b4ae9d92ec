"""Per-video resumable progress manifest (the port of
``vse_tpu/pipeline/resume.py``, with the same on-disk format: a manifest
written by either package loads in the other).

The extractor's fps strategy periodically journals the processed-frame
watermark and the raw OCR records next to the video; an interrupted run
resumes from the last watermark instead of re-OCRing the whole video.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional

from vse_tpu_torch.post.records import RawRecord


MANIFEST_VERSION = 1


@dataclass
class ProgressManifest:
    video_path: str
    mode: str
    last_frame_no: int = 0
    records: List[RawRecord] = field(default_factory=list)

    @staticmethod
    def path_for(video_path: str) -> str:
        d = os.path.dirname(os.path.abspath(video_path))
        base = os.path.splitext(os.path.basename(video_path))[0]
        return os.path.join(d, f".{base}.vse-progress.json")

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path_for(self.video_path)
        payload = {
            "version": MANIFEST_VERSION,
            "video_path": self.video_path,
            "mode": self.mode,
            "last_frame_no": self.last_frame_no,
            "records": [
                [r.frame_no, list(r.coord), r.text] for r in self.records
            ],
        }
        # atomic write so a crash never leaves a torn manifest
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(payload, f, ensure_ascii=False)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
        return path

    @classmethod
    def load(cls, video_path: str, mode: str) -> Optional["ProgressManifest"]:
        """Returns the manifest if one exists and matches (video, mode)."""
        path = cls.path_for(video_path)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "r", encoding="utf-8") as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if (
            payload.get("version") != MANIFEST_VERSION
            or payload.get("mode") != mode
            or os.path.abspath(payload.get("video_path", "")) != os.path.abspath(video_path)
        ):
            return None
        return cls(
            video_path=video_path,
            mode=mode,
            last_frame_no=int(payload.get("last_frame_no", 0)),
            records=[
                RawRecord(int(no), tuple(coord), text)
                for no, coord, text in payload.get("records", [])
            ],
        )

    def clear(self) -> None:
        path = self.path_for(self.video_path)
        if os.path.exists(path):
            os.remove(path)
