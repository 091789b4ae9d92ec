"""Watermark and scene-text filters over raw OCR records (the port of
``vse_tpu/post/filters.py``).

Host-side (these operate on tiny coordinate statistics — SURVEY.md C5/C6
mark them cheap), re-implemented from the reference's file-rewriting loops
(reference backend/main.py:506-612, 671-729, 866-881) as pure functions over
in-memory records. Interactivity is factored out into a `confirm` callback:
the reference prompts y/n on stdin; callers can pass `input`-backed prompts,
an always-yes policy (batch mode), or a GUI hook.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Callable, List, Optional, Sequence, Tuple

from vse_tpu_torch.post.records import RawRecord

Coord = Tuple[int, int, int, int]  # (xmin, xmax, ymin, ymax)
ConfirmFn = Callable[[str], bool]

# the two prompts of the JAX package's English message catalog that the
# filters ask (vse_tpu/core/i18n.py, keys QuestionDelete and DeleteNoSubArea)
QUESTION_DELETE = "{0} appears {1}x — delete this area's text? [y/n] "
DELETE_NO_SUB_AREA = "keep only lines inside y band {0}? [y/n] "


def always_yes(_prompt: str) -> bool:
    return True


def unite_coordinates(
    coords: Sequence[Coord],
    tolerant_pixel_x: int = 100,
    tolerant_pixel_y: int = 50,
) -> List[Coord]:
    """Snap similar coordinates to one representative (reference
    backend/main.py:866-881 `_unite_coordinates`): coordinate A is replaced by
    the *last* similar coordinate in the list, "similar" meaning all four
    deltas within the pixel tolerances (reference backend/main.py:954-962).

    The reference scans O(n^2); we keep its exact replace-by-last semantics
    but bucket by a coarse grid first so typical inputs are near-linear.
    """

    def similar(c1: Coord, c2: Coord) -> bool:
        return (
            abs(c1[0] - c2[0]) < tolerant_pixel_x
            and abs(c1[1] - c2[1]) < tolerant_pixel_x
            and abs(c1[2] - c2[2]) < tolerant_pixel_y
            and abs(c1[3] - c2[3]) < tolerant_pixel_y
        )

    coords = list(coords)
    tx = max(1, tolerant_pixel_x)
    ty = max(1, tolerant_pixel_y)
    # grid bucket by quantized coordinates: similar coords differ by < tol
    # per component, so a match's cell index differs by at most 1 per axis —
    # candidates live in the 3^4 neighboring cells
    cells = defaultdict(list)  # cell -> [(index, coord)]
    for i, c in enumerate(coords):
        cells[(c[0] // tx, c[1] // tx, c[2] // ty, c[3] // ty)].append((i, c))

    out: List[Coord] = []
    for c in coords:
        k = (c[0] // tx, c[1] // tx, c[2] // ty, c[3] // ty)
        best_i, rep = -1, c
        for d0 in (-1, 0, 1):
            for d1 in (-1, 0, 1):
                for d2 in (-1, 0, 1):
                    for d3 in (-1, 0, 1):
                        for i, cand in cells.get(
                            (k[0] + d0, k[1] + d1, k[2] + d2, k[3] + d3), ()
                        ):
                            if i > best_i and similar(c, cand):
                                best_i, rep = i, cand
        out.append(rep)  # last similar wins, as in the reference
    return out


def detect_watermark_areas(
    records: Sequence[RawRecord],
    watermark_area_num: int = 5,
    tolerant_pixel_x: int = 100,
    tolerant_pixel_y: int = 50,
) -> List[Tuple[Coord, int]]:
    """Top-N most frequent (united) coordinates — watermark candidates
    (reference backend/main.py:671-711 `_detect_watermark_area`)."""
    united = unite_coordinates(
        [r.coord for r in records], tolerant_pixel_x, tolerant_pixel_y
    )
    return Counter(united).most_common(watermark_area_num)


def auto_watermark_policy(
    coord: Coord, matching: Sequence[RawRecord], min_count: int = 10
) -> bool:
    """Non-interactive stand-in for the reference's y/n prompt (reference
    backend/main.py:551-555): a watermark/logo repeats the SAME text in the
    same place, while subtitles at a fixed position change text. Drop a
    candidate only when it recurs enough and its text is near-constant."""
    if len(matching) < min_count:
        return False
    texts = {r.text.strip() for r in matching}
    return len(texts) <= max(1, len(matching) // 10)


def filter_watermark(
    records: List[RawRecord],
    watermark_area_num: int = 5,
    tolerant_pixel_x: int = 100,
    tolerant_pixel_y: int = 50,
    confirm: Optional[ConfirmFn] = None,
) -> List[RawRecord]:
    """Drop records whose coordinate matches a confirmed watermark candidate
    (reference backend/main.py:506-565). The reference rewrites raw.txt by
    substring match on `str(coord)`; we match on the united coordinate.
    With `confirm=None` the auto text-constancy policy decides."""
    united = unite_coordinates(
        [r.coord for r in records], tolerant_pixel_x, tolerant_pixel_y
    )
    candidates = Counter(united).most_common(watermark_area_num)
    to_drop = set()
    for coord, count in candidates:
        if confirm is not None:
            drop = confirm(QUESTION_DELETE.format(coord, count))
        else:
            matching = [r for r, u in zip(records, united) if u == coord]
            drop = auto_watermark_policy(coord, matching)
        if drop:
            to_drop.add(coord)
    return [r for r, u in zip(records, united) if u not in to_drop]


def detect_subtitle_band(records: Sequence[RawRecord]) -> Tuple[int, int]:
    """Most common (ymin, ymax) band (reference backend/main.py:713-729
    `_detect_subtitle_area`)."""
    ys = [(r.coord[2], r.coord[3]) for r in records]
    if not ys:
        return (0, 0)
    return Counter(ys).most_common(1)[0][0]


def filter_scene_text(
    records: List[RawRecord],
    subtitle_area_deviation_pixel: int = 50,
    confirm: ConfirmFn = always_yes,
) -> List[RawRecord]:
    """Keep only records inside the modal y band expanded by the deviation
    tolerance (reference backend/main.py:567-612)."""
    band = detect_subtitle_band(records)
    ymin = abs(band[0] - subtitle_area_deviation_pixel)
    ymax = band[1] + subtitle_area_deviation_pixel
    if not confirm(DELETE_NO_SUB_AREA.format((ymin, ymax))):
        return records
    return [
        r for r in records if ymin <= r.coord[2] and r.coord[3] <= ymax
    ]
