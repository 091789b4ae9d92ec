"""Raw OCR record model (the parts of the JAX package's module that the
port's main path uses).

The reference streams OCR output through a ``raw.txt`` file (reference
backend/tools/subtitle_ocr.py:64-66, backend/main.py:671-729); the port, like
the JAX package, keeps the records in memory.
"""

from __future__ import annotations

import unicodedata
from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class RawRecord:
    frame_no: int
    coord: Tuple[int, int, int, int]  # (xmin, xmax, ymin, ymax)
    text: str


def concat_same_frame(records: List[RawRecord]) -> List[RawRecord]:
    """Merge records sharing a frame number into one line (reference
    backend/main.py:820-864 `_concat_content_with_same_frameno`): texts join
    with spaces (embedded newlines flattened), the merged record keeps the
    first occurrence's coordinate, and text is NFKC-normalized."""
    by_frame: dict = {}
    order: List[int] = []
    for r in records:
        if r.frame_no not in by_frame:
            by_frame[r.frame_no] = []
            order.append(r.frame_no)
        by_frame[r.frame_no].append(r)
    out: List[RawRecord] = []
    for frame_no in order:
        group = by_frame[frame_no]
        if len(group) == 1:
            text = group[0].text
        else:
            text = " ".join(g.text for g in group).replace("\n", " ")
        text = unicodedata.normalize("NFKC", text)
        out.append(RawRecord(frame_no, group[0].coord, text))
    return out
