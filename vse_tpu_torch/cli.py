"""Command-line interface of the port.

    python -m vse_tpu_torch.cli extract VIDEO --area ymin,ymax,xmin,xmax \\
        --mode fast --language en --no-word-segmentation [--device cuda]

Writes VIDEO's SRT next to it. Runs on the card unless ``--device cpu`` is
given. This slice ports the keyframe strategy (an area, mode fast) for
``en``; decoding a file needs OpenCV.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional


def parse_area(area_arg: str, width: int, height: int):
    """'ymin,ymax,xmin,xmax' in pixels, or as ratios when all are <= 1."""
    from vse_tpu_torch.core.subtitle_area import SubtitleArea

    parts = [float(t) for t in area_arg.replace(";", ",").split(",")[:4]]
    if len(parts) != 4:
        raise ValueError(f"expected 4 values, got {len(parts)}")
    if all(p <= 1.0 for p in parts):
        return SubtitleArea.from_ratios(",".join(str(p) for p in parts), width, height)
    ymin, ymax, xmin, xmax = (int(p) for p in parts)
    return SubtitleArea(ymin, ymax, xmin, xmax)


def cmd_extract(args) -> int:
    from vse_tpu_torch.core.config import Mode, VseConfig
    from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
    from vse_tpu_torch.video.decode import probe

    meta = probe(args.video)
    try:
        sub_area = parse_area(args.area, meta.width, meta.height)
    except ValueError as e:
        print(f"error: --area must be 'ymin,ymax,xmin,xmax' (pixels or 0-1 "
              f"ratios), got {args.area!r}: {e}", file=sys.stderr)
        return 2
    cfg = VseConfig(language=args.language, mode=Mode(args.mode),
                    word_segmentation=not args.no_word_segmentation)
    print(SubtitleExtractor(args.video, sub_area, cfg, device=args.device).run())
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="vse_tpu_torch",
                                 description="hard-subtitle extractor (PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="command")
    p = sub.add_parser("extract", help="extract hard subtitles from a video")
    p.add_argument("video", help="video file")
    p.add_argument("--area", required=True, metavar="ymin,ymax,xmin,xmax",
                   help="subtitle area in pixels (or ratios <= 1.0)")
    p.add_argument("--language", default="en", help="subtitle language")
    p.add_argument("--mode", default="fast", choices=["fast"])
    p.add_argument("--no-word-segmentation", action="store_true",
                   help="required: word segmentation is not ported yet")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.command == "extract":
        return cmd_extract(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
