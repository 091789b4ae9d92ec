"""Re-timer CLI — the JAX package's flags (``vse_tpu/sync/cli.py``, the
reference's sushi CLI, backend/sushi/__main__.py:47-123) and ``--device``
(``cuda``, the default, or ``cpu``). Run as ``python -m
vse_tpu_torch.sync.cli``, ``python -m vse_tpu_torch.sync`` or ``python -m
vse_tpu_torch.cli sync``."""

from __future__ import annotations

import argparse
import logging
import sys
import time

VERSION = "0.1.0"


def create_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="vse-tpu timeline sync — audio-correlation subtitle re-timer")
    p.add_argument("--window", default=10, type=int, metavar="<size>")
    p.add_argument("--max-window", default=30, type=int, dest="max_window", metavar="<size>")
    p.add_argument("--rewind-thresh", default=5, type=int, dest="rewind_thresh", metavar="<events>")
    p.add_argument("--no-grouping", action="store_false", dest="grouping")
    p.add_argument("--max-kf-distance", default=2, type=float, dest="max_kf_distance", metavar="<frames>")
    p.add_argument("--kf-mode", default="all", choices=["shift", "snap", "all"], dest="kf_mode")
    p.add_argument("--smooth-radius", default=3, type=int, dest="smooth_radius", metavar="<events>")
    p.add_argument("--max-ts-duration", default=1001.0 / 24000.0 * 10, type=float,
                   dest="max_ts_duration", metavar="<seconds>")
    p.add_argument("--max-ts-distance", default=1001.0 / 24000.0 * 10, type=float,
                   dest="max_ts_distance", metavar="<seconds>")
    p.add_argument("--test-shift-plot", default=None, dest="plot_path", help=argparse.SUPPRESS)
    p.add_argument("--sample-type", default="uint8", choices=["float32", "uint8"], dest="sample_type")
    p.add_argument("--sample-rate", default=12000, type=int, dest="sample_rate", metavar="<rate>")
    p.add_argument("--src-audio", default=None, type=int, dest="src_audio_idx", metavar="<id>")
    p.add_argument("--src-script", default=None, type=int, dest="src_script_idx", metavar="<id>")
    p.add_argument("--dst-audio", default=None, type=int, dest="dst_audio_idx", metavar="<id>")
    p.add_argument("--no-cleanup", action="store_false", dest="cleanup")
    p.add_argument("--temp-dir", default=None, dest="temp_dir", metavar="<string>")
    p.add_argument("--chapters", default=None, dest="chapters_file", metavar="<filename>")
    p.add_argument("--script", default=None, dest="script_file", metavar="<filename>")
    p.add_argument("--dst-keyframes", default=None, dest="dst_keyframes", metavar="<filename>")
    p.add_argument("--src-keyframes", default=None, dest="src_keyframes", metavar="<filename>")
    p.add_argument("--dst-fps", default=None, type=float, dest="dst_fps", metavar="<fps>")
    p.add_argument("--src-fps", default=None, type=float, dest="src_fps", metavar="<fps>")
    p.add_argument("--dst-timecodes", default=None, dest="dst_timecodes", metavar="<filename>")
    p.add_argument("--src-timecodes", default=None, dest="src_timecodes", metavar="<filename>")
    p.add_argument("--src", required=True, dest="source", metavar="<filename>")
    p.add_argument("--dst", required=True, dest="destination", metavar="<filename>")
    p.add_argument("-o", "--output", default=None, dest="output_script", metavar="<filename>")
    p.add_argument("-v", "--verbose", default=False, action="store_true", dest="verbose")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--version", action="version", version=VERSION)
    return p


def parse_args_and_run(argv):
    from vse_tpu_torch.sync.runner import run

    args = create_arg_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s: %(message)s",
    )
    t0 = time.time()
    out = run(args)
    logging.info("done in %.2fs -> %s", time.time() - t0, out)
    return out


def main():
    from vse_tpu_torch.sync.common import SyncError

    try:
        parse_args_and_run(sys.argv[1:])
    except SyncError as e:
        logging.critical(str(e))
        sys.exit(2)


if __name__ == "__main__":
    main()
