"""Top-level re-timer flow (the port of ``vse_tpu/sync/runner.py``; reference
backend/sushi/__init__.py:491-699): validate -> demux -> load WAVs -> search
groups -> shifts -> grouping fixes -> keyframe snapping -> save. The device
(``args.device``, ``cuda`` unless ``cpu`` is given) is resolved once, at
the start: it runs K2 for keyframe logs the demuxer makes and the device
matcher when that is asked for."""

from __future__ import annotations

import logging
import os
from typing import List, Optional

from vse_tpu_torch.device import resolve_device
from vse_tpu_torch.sync import engine
from vse_tpu_torch.sync.common import SyncError, get_extension
from vse_tpu_torch.sync.demux import Demuxer
from vse_tpu_torch.sync.events import AssScript, SrtScript
from vse_tpu_torch.sync.timecodes import (
    Timecodes,
    get_ogm_start_times,
    get_xml_start_times,
    parse_keyframes,
)
from vse_tpu_torch.sync.wav import WavStream

log = logging.getLogger("vse_tpu_torch.sync")


def _check_exists(path: Optional[str], title: str):
    if path and not os.path.exists(path):
        raise SyncError(f"{title} file doesn't exist")


def _temp_path(temp_dir: Optional[str], base: str, postfix: str) -> str:
    if temp_dir:
        return os.path.join(temp_dir, os.path.basename(base) + postfix)
    return base + postfix


def _write_shift_plot(events, plot_path: str) -> None:
    """Diagnostic per-event shift plot (reference gates the same behind
    --test-shift-plot, backend/sushi/__init__.py:497,691-694)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        log.warning("matplotlib unavailable; skipping shift plot")
        return
    plt.clf()
    plt.ylabel("Shift, seconds")
    plt.xlabel("Event index")
    plt.plot([e.shift for e in events], label="final shift")
    plt.legend(fontsize=5, frameon=False, fancybox=False)
    plt.savefig(plot_path, dpi=300)


def run(args) -> str:
    """Args: an argparse namespace from vse_tpu_torch.sync.cli (the JAX
    package's flags and ``--device``). Returns the output script path.
    Raises without CUDA unless the device is ``cpu``."""
    device = resolve_device(getattr(args, "device", "cuda"))
    ignore_chapters = args.chapters_file is not None and args.chapters_file.lower() == "none"
    _check_exists(args.source, "Source")
    _check_exists(args.destination, "Destination")
    _check_exists(args.src_timecodes, "Source timecodes")
    _check_exists(args.dst_timecodes, "Destination timecodes")
    _check_exists(args.script_file, "Script")
    if not ignore_chapters:
        _check_exists(args.chapters_file, "Chapters")
    if args.src_keyframes not in (None, "auto", "make"):
        _check_exists(args.src_keyframes, "Source keyframes")
    if args.dst_keyframes not in (None, "auto", "make"):
        _check_exists(args.dst_keyframes, "Destination keyframes")
    if (args.src_timecodes and args.src_fps) or (args.dst_timecodes and args.dst_fps):
        raise SyncError("fps and timecodes cannot both be specified")

    src_demuxer = Demuxer(args.source, device)
    dst_demuxer = Demuxer(args.destination, device)
    if src_demuxer.is_wav and not args.script_file:
        raise SyncError("Script file isn't specified")
    if bool(args.src_keyframes) != bool(args.dst_keyframes):
        raise SyncError("either none or both of src/dst keyframes required")
    if args.temp_dir and not os.path.exists(args.temp_dir):
        os.makedirs(args.temp_dir)

    # audio selection
    if src_demuxer.is_wav:
        src_audio = args.source
    else:
        src_audio = _temp_path(args.temp_dir, args.source, ".sync.wav")
        src_demuxer.set_audio(args.src_audio_idx, src_audio, args.sample_rate)
    if dst_demuxer.is_wav:
        dst_audio = args.destination
    else:
        dst_audio = _temp_path(args.temp_dir, args.destination, ".sync.wav")
        dst_demuxer.set_audio(args.dst_audio_idx, dst_audio, args.sample_rate)

    # script selection
    if args.script_file:
        src_script = args.script_file
    else:
        stype = src_demuxer.get_subs_type(args.src_script_idx)
        src_script = _temp_path(args.temp_dir, args.source, ".sync" + stype)
        src_demuxer.set_script(args.src_script_idx, src_script)
    ext = get_extension(src_script)
    if ext not in (".ass", ".srt"):
        raise SyncError("unknown script type")
    if args.output_script:
        if get_extension(args.output_script) != ext:
            raise SyncError("source/destination script types don't match")
        dst_script = args.output_script
    else:
        dst_script = _temp_path(args.temp_dir, args.destination, ".sync" + ext)

    # chapters
    chapter_times: List[float] = []
    if args.grouping and not ignore_chapters:
        if args.chapters_file:
            if get_extension(args.chapters_file) == ".xml":
                chapter_times = get_xml_start_times(args.chapters_file)
            else:
                chapter_times = get_ogm_start_times(args.chapters_file)
        elif not src_demuxer.is_wav:
            chapter_times = src_demuxer.chapters

    # keyframe/timecode selection (reference backend/sushi/__init__.py:578-607):
    # 'auto' reuses a previously generated log, 'make' regenerates; timecodes
    # auto-extract from the container when neither a file nor fps is given
    src_kf_file = dst_kf_file = None
    src_tc_file, dst_tc_file = args.src_timecodes, args.dst_timecodes
    if args.src_keyframes:
        def select_keyframes(file_arg: str, demuxer: Demuxer) -> str:
            auto_file = _temp_path(args.temp_dir, demuxer.path,
                                   ".sync.keyframes.txt")
            if file_arg in ("auto", "make"):
                if file_arg == "make" or not os.path.exists(auto_file):
                    if not demuxer.has_video:
                        raise SyncError(
                            f"cannot make keyframes for {demuxer.path}: "
                            "it has no video stream"
                        )
                    demuxer.set_keyframes(auto_file)
                return auto_file
            return file_arg

        def select_timecodes(external: Optional[str], fps_arg, demuxer: Demuxer):
            if external:
                return external
            if fps_arg:
                return None
            if demuxer.has_video:
                path = _temp_path(args.temp_dir, demuxer.path,
                                  ".sync.timecodes.txt")
                demuxer.set_timecodes(path)
                return path
            raise SyncError(
                "fps, timecodes or video files must be provided when "
                "keyframes are used"
            )

        src_kf_file = select_keyframes(args.src_keyframes, src_demuxer)
        dst_kf_file = select_keyframes(args.dst_keyframes, dst_demuxer)
        src_tc_file = select_timecodes(args.src_timecodes, args.src_fps, src_demuxer)
        dst_tc_file = select_timecodes(args.dst_timecodes, args.dst_fps, dst_demuxer)

    src_demuxer.demux()
    dst_demuxer.demux()
    try:
        src_kt = dst_kt = src_tc = dst_tc = None
        if args.src_keyframes:
            src_tc = (
                Timecodes.cfr(args.src_fps) if args.src_fps
                else Timecodes.from_file(src_tc_file)
            )
            src_kt = [src_tc.get_frame_time(f) for f in parse_keyframes(src_kf_file)]
            dst_tc = (
                Timecodes.cfr(args.dst_fps) if args.dst_fps
                else Timecodes.from_file(dst_tc_file)
            )
            dst_kt = [dst_tc.get_frame_time(f) for f in parse_keyframes(dst_kf_file)]

        script = (
            AssScript.from_file(src_script) if ext == ".ass"
            else SrtScript.from_file(src_script)
        )
        script.sort_by_time()

        src_stream = WavStream(src_audio, args.sample_rate, args.sample_type, device=device)
        dst_stream = WavStream(dst_audio, args.sample_rate, args.sample_type, device=device)

        groups = engine.prepare_search_groups(
            script.events,
            source_duration=src_stream.duration_seconds,
            chapter_times=chapter_times,
            max_ts_duration=args.max_ts_duration,
            max_ts_distance=args.max_ts_distance,
        )
        engine.calculate_shifts(
            src_stream, dst_stream, groups,
            normal_window=args.window,
            max_window=args.max_window,
            rewind_thresh=args.rewind_thresh if args.grouping else 0,
        )
        events = script.events
        if args.grouping:
            if not ignore_chapters and chapter_times:
                gs = engine.groups_from_chapters(events, chapter_times)
                for g in gs:
                    engine.fix_near_borders(g)
                    engine.smooth_events([e for e in g if not e.linked], args.smooth_radius)
                gs = engine.split_broken_groups(gs)
            else:
                engine.fix_near_borders(events)
                engine.smooth_events([e for e in events if not e.linked], args.smooth_radius)
                gs = engine.detect_groups(events)
            for g in gs:
                engine.average_shifts(g)
            if args.src_keyframes:
                for e in (x for x in events if x.linked):
                    e.resolve_link()
                for g in gs:
                    engine.snap_groups_to_keyframes(
                        g, chapter_times, args.max_ts_duration, args.max_ts_distance,
                        src_kt, dst_kt, src_tc, dst_tc, args.max_kf_distance, args.kf_mode,
                    )
        else:
            engine.fix_near_borders(events)
            if args.src_keyframes:
                for e in (x for x in events if x.linked):
                    e.resolve_link()
                engine.snap_groups_to_keyframes(
                    events, chapter_times, args.max_ts_duration, args.max_ts_distance,
                    src_kt, dst_kt, src_tc, dst_tc, args.max_kf_distance, args.kf_mode,
                )
        if getattr(args, "plot_path", None):
            _write_shift_plot(events, args.plot_path)
        for e in events:
            e.apply_shift()
        script.save_to_file(dst_script)
        return dst_script
    finally:
        if args.cleanup:
            src_demuxer.cleanup()
            dst_demuxer.cleanup()
