"""Subtitle area bean (reference backend/bean/subtitle_area.py:7-48); the
parts of the JAX package's module that the port's main path uses.

A rectangular region, optionally bound to a frame-range ("AB section"), plus
pure-numpy overlap math replacing the reference's shapely polygon gate
(reference backend/tools/subtitle_ocr.py:50-66): the boxes involved are
axis-aligned rectangles, so GEOS is unnecessary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class ABSection:
    """A frame range [start, end]; -1 end = to the last frame."""

    start_frame: int = 0
    end_frame: int = -1

    def contains(self, frame_no: int) -> bool:
        if frame_no < self.start_frame:
            return False
        return self.end_frame < 0 or frame_no <= self.end_frame


@dataclass
class SubtitleArea:
    """(ymin, ymax, xmin, xmax) pixel rectangle — the reference's field order
    (reference backend/bean/subtitle_area.py:7-20)."""

    ymin: int
    ymax: int
    xmin: int
    xmax: int
    ab_section: Optional[ABSection] = None

    @classmethod
    def from_ratios(
        cls, ratios: str, width: int, height: int
    ) -> "SubtitleArea":
        """Parse a "ymin,ymax,xmin,xmax" ratio string (reference
        backend/config.py:49 default "0.78,0.99,0.05,0.95") against a video
        size."""
        ry0, ry1, rx0, rx1 = (float(t) for t in ratios.split(","))
        return cls(
            ymin=int(ry0 * height),
            ymax=int(ry1 * height),
            xmin=int(rx0 * width),
            xmax=int(rx1 * width),
        )

    def as_tuple(self) -> Tuple[int, int, int, int]:
        return (self.ymin, self.ymax, self.xmin, self.xmax)

    @property
    def width(self) -> int:
        return self.xmax - self.xmin

    @property
    def height(self) -> int:
        return self.ymax - self.ymin

    def area(self) -> float:
        return max(0, self.width) * max(0, self.height)

    def intersection_area(self, xmin: float, xmax: float, ymin: float, ymax: float) -> float:
        """Axis-aligned rectangle intersection area."""
        iw = min(self.xmax, xmax) - max(self.xmin, xmin)
        ih = min(self.ymax, ymax) - max(self.ymin, ymin)
        if iw <= 0 or ih <= 0:
            return 0.0
        return float(iw) * float(ih)

    def overflow_area_rate(self, xmin: float, xmax: float, ymin: float, ymax: float) -> float:
        """The reference's gate statistic (reference
        backend/tools/subtitle_ocr.py:55-60):

            (area(sub) + area(box) - area(intersection)) / area(sub) - 1

        i.e. the fraction of the union lying outside the subtitle area,
        normalized by the subtitle area. Returns +inf when disjoint
        (the reference drops disjoint boxes unconditionally,
        subtitle_ocr.py:62-66).
        """
        inter = self.intersection_area(xmin, xmax, ymin, ymax)
        if inter <= 0.0:
            return float("inf")
        box_area = max(0.0, (xmax - xmin)) * max(0.0, (ymax - ymin))
        sa = self.area()
        if sa <= 0:
            return float("inf")
        return (sa + box_area - inter) / sa - 1.0
