"""Command-line interface of the port.

    python -m vse_tpu_torch.cli extract VIDEO [VIDEO ...] \\
        [--area ymin,ymax,xmin,xmax] [--language ch] [--mode fast] \\
        [--config config.json] [--output DIR] [--txt] \\
        [--no-word-segmentation] [--interactive-filters] [--device cuda]
    python -m vse_tpu_torch.cli sync --src SRC --dst DST --script S [...] \\
        [--device cuda]
    python -m vse_tpu_torch.cli gui [--host H] [--port P] [--config C] \\
        [--device cuda]

Writes each video's SRT next to it (or into ``--output``); one OCR engine
serves all the videos. With no ``--area`` it runs the fps strategy with the
watermark and scene-text filters; with one, the keyframe strategy. Runs on
the card unless ``--device cpu`` is given. With no ``--language`` the
config's language runs (``VseConfig.language``, ``ch``), as in the JAX
package. ``--config`` reads a reference-format ``config.json`` (``{"Main":
{...}}``, ``VseConfig.from_json``); the flags given override it. Mode fast
is ported, for every language; decoding a file needs OpenCV. A missing
video makes the exit code 1. ``sync`` runs the audio re-timer with the JAX
package's flags (``vse_tpu_torch/sync/cli.py``) and ``gui`` the web GUI
(``vse_tpu_torch/gui/server.py``), routed as the JAX CLI routes them; both
run on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
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


def ask(prompt: str) -> bool:
    """The reference's y/n prompt for the filters (empty answers yes)."""
    return input(f"{prompt} [y/n] ").strip().lower() in ("y", "")


def cmd_extract(args) -> int:
    from vse_tpu_torch.core.config import Mode, VseConfig
    from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
    from vse_tpu_torch.video.decode import probe

    cfg = VseConfig.from_json(args.config) if args.config else VseConfig()
    overrides = {}
    if args.language:
        overrides["language"] = args.language
    if args.mode:
        overrides["mode"] = Mode(args.mode)
    if args.txt:
        overrides["generate_txt"] = True
    if args.no_word_segmentation:
        overrides["word_segmentation"] = False
    if overrides:
        cfg = cfg.replace(**overrides)
    confirm = ask if args.interactive_filters else None
    rc = 0
    engine = None
    for video in args.videos:
        if not os.path.exists(video):
            print(f"not found: {video}", file=sys.stderr)
            rc = 1
            continue
        sub_area = None
        if args.area is not None:
            meta = probe(video)
            try:
                sub_area = parse_area(args.area, meta.width, meta.height)
            except ValueError as e:
                print(f"error: --area must be 'ymin,ymax,xmin,xmax' (pixels or "
                      f"0-1 ratios), got {args.area!r}: {e}", file=sys.stderr)
                return 2
        ex = SubtitleExtractor(video, sub_area, cfg, engine=engine,
                               device=args.device, confirm=confirm)
        if args.output:
            os.makedirs(args.output, exist_ok=True)
            ex.subtitle_output_path = os.path.join(args.output, Path(video).stem + ".srt")
        print(ex.run())
        engine = ex.engine  # one engine for every video of the call
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="vse_tpu_torch",
                                 description="hard-subtitle extractor (PyTorch/CUDA port)")
    sub = ap.add_subparsers(dest="command")
    p = sub.add_parser("extract", help="extract hard subtitles from videos")
    p.add_argument("videos", nargs="+", help="video file(s)")
    p.add_argument("--area", default=None, metavar="ymin,ymax,xmin,xmax",
                   help="subtitle area in pixels (or ratios <= 1.0); without "
                        "one, the fps strategy and its filters run")
    p.add_argument("--language", default=None,
                   help="subtitle language (default: the config's, ch)")
    p.add_argument("--mode", default=None, choices=["fast"],
                   help="recognition mode (default: the config's, fast)")
    p.add_argument("--config", default=None,
                   help="path to a config.json in the reference's format")
    p.add_argument("--output", default=None, help="output directory (default: the video's)")
    p.add_argument("--txt", action="store_true", help="also write a .txt transcript")
    p.add_argument("--no-word-segmentation", action="store_true")
    p.add_argument("--interactive-filters", action="store_true",
                   help="ask y/n for the watermark and scene-text filters")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sub.add_parser("sync", add_help=False,
                   help="audio-correlation subtitle re-timer (sushi-compatible flags, --device)")
    sub.add_parser("gui", add_help=False,
                   help="browser-based GUI (http server; see vse_tpu_torch/gui)")
    args, rest = ap.parse_known_args(argv)
    if args.command == "extract":
        if rest:
            ap.error(f"unrecognized arguments: {' '.join(rest)}")
        return cmd_extract(args)
    if args.command == "sync":
        from vse_tpu_torch.sync.cli import parse_args_and_run

        parse_args_and_run(rest)
        return 0
    if args.command == "gui":
        from vse_tpu_torch.gui.server import main as gui_main

        gui_main(rest)
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
