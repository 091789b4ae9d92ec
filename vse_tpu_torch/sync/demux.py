"""Media demuxing for the re-timer: ffmpeg stream probing/extraction (the
port of ``vse_tpu/sync/demux.py``).

Rebuilds the reference's Demuxer/FFmpeg wrappers (reference
backend/sushi/demux.py:10-135): probe stream layout by parsing `ffmpeg -i`
output, extract audio (to WAV at a given sample rate), subtitles, chapters
and timecodes via subprocess. Gated: environments without an ffmpeg binary
(this CI image) can still re-time WAV inputs directly — only video-container
inputs need the demuxer. ``make_keyframes`` writes the SCXviD keyframe log
with kernel K2's f32-gray form on the given device.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from vse_tpu_torch.sync.common import SyncError, get_extension


def ffmpeg_path() -> Optional[str]:
    return os.environ.get("VSE_FFMPEG") or shutil.which("ffmpeg")


@dataclass
class MediaStreamInfo:
    id: int
    info: str
    default: bool
    title: Optional[str] = None


@dataclass
class MediaInfo:
    video: List[MediaStreamInfo] = field(default_factory=list)
    audio: List[MediaStreamInfo] = field(default_factory=list)
    subtitles: List[MediaStreamInfo] = field(default_factory=list)
    chapter_times: List[float] = field(default_factory=list)


_STREAM_RE = re.compile(
    r"Stream\s*#0[:.](\d+).*?:\s*(Video|Audio|Subtitle):\s*(.*)"
)
_CHAPTER_RE = re.compile(r"Chapter #0[:.]\d+: start (\d+\.\d+)")


def parse_ffmpeg_info(output: str) -> MediaInfo:
    info = MediaInfo()
    for m in _STREAM_RE.finditer(output):
        sid, kind, rest = int(m.group(1)), m.group(2), m.group(3)
        s = MediaStreamInfo(sid, rest, "(default)" in rest)
        if kind == "Video":
            info.video.append(s)
        elif kind == "Audio":
            info.audio.append(s)
        else:
            info.subtitles.append(s)
    info.chapter_times = [float(m.group(1)) for m in _CHAPTER_RE.finditer(output)]
    return info


def get_media_info(path: str) -> MediaInfo:
    exe = ffmpeg_path()
    if not exe:
        raise SyncError(
            "ffmpeg not found: video-container inputs need ffmpeg; "
            "pass WAV files directly, or set VSE_FFMPEG"
        )
    proc = subprocess.run(
        [exe, "-hide_banner", "-i", path],
        capture_output=True, text=True,
    )
    return parse_ffmpeg_info(proc.stderr)


def _pick_stream(streams: List[MediaStreamInfo], idx: Optional[int], kind: str):
    if not streams:
        raise SyncError(f"no {kind} streams found")
    if idx is None:
        default = next((s for s in streams if s.default), None)
        return default or streams[0]
    s = next((s for s in streams if s.id == idx), None)
    if s is None:
        raise SyncError(f"{kind} stream #{idx} not found")
    return s


class Demuxer:
    """Plans extraction operations, then runs them in one ffmpeg invocation
    (reference demux.py:10-60)."""

    def __init__(self, path: str, device="cuda"):
        self.path = path
        self.device = device  # where make_keyframes runs K2
        self.is_wav = get_extension(path) == ".wav"
        self._info = None if self.is_wav else get_media_info(path)
        self._audio: Optional[Tuple[int, str, Optional[int]]] = None
        self._script: Optional[Tuple[int, str]] = None
        self._chapters_out: Optional[str] = None
        self._timecodes: Optional[Tuple[int, str]] = None
        self._keyframes_out: Optional[str] = None
        self._produced: List[str] = []

    @property
    def chapters(self) -> List[float]:
        return [] if self.is_wav else self._info.chapter_times

    @property
    def has_video(self) -> bool:
        return bool(self._info and self._info.video)

    def get_subs_type(self, idx: Optional[int]) -> str:
        s = _pick_stream(self._info.subtitles, idx, "subtitle")
        return ".ass" if "ass" in s.info else ".srt"

    def set_audio(self, stream_idx: Optional[int], output_path: str,
                  sample_rate: Optional[int]):
        s = _pick_stream(self._info.audio, stream_idx, "audio")
        self._audio = (s.id, output_path, sample_rate)

    def set_script(self, stream_idx: Optional[int], output_path: str):
        s = _pick_stream(self._info.subtitles, stream_idx, "subtitle")
        self._script = (s.id, output_path)

    def set_chapters(self, output_path: str):
        self._chapters_out = output_path

    def set_timecodes(self, output_path: str):
        """Plan per-frame timecode extraction (mkvtimestamp_v2 via ffmpeg;
        reference demux.py:49-52, with the mkvextract fallback of
        reference demux.py:106-110 when ffmpeg can't produce them)."""
        s = _pick_stream(self._info.video, None, "video")
        self._timecodes = (s.id, output_path)

    def set_keyframes(self, output_path: str):
        """Plan keyframe-log generation (the reference pipes ffmpeg yuv4mpeg
        into the SCXvid binary, reference demux.py:113-135; here the
        framework's own scene-cut scanner writes the SCXviD-format log —
        no external binaries)."""
        self._keyframes_out = output_path

    def demux(self):
        if self.is_wav:
            return
        args = [ffmpeg_path(), "-hide_banner", "-y", "-i", self.path]
        if self._audio is not None:
            sid, out, rate = self._audio
            args += ["-map", f"0:{sid}"]
            if rate:
                args += ["-ar", str(rate)]
            args += ["-ac", "1", "-acodec", "pcm_s16le", out]
            self._produced.append(out)
        if self._script is not None:
            sid, out = self._script
            args += ["-map", f"0:{sid}", out]
            self._produced.append(out)
        if self._timecodes is not None:
            sid, out = self._timecodes
            args += ["-map", f"0:{sid}", "-f", "mkvtimestamp_v2", out]
            self._produced.append(out)
        rc = subprocess.run(args, capture_output=True).returncode
        if rc != 0:
            raise SyncError(f"ffmpeg demux failed (rc={rc})")
        if self._timecodes is not None and not os.path.exists(
            self._timecodes[1]
        ):
            # mkvextract fallback (reference demux.py:106-110)
            mkvextract_timecodes(self.path, self._timecodes[0],
                                 self._timecodes[1])
        if self._keyframes_out is not None:
            make_keyframes(self.path, self._keyframes_out, device=self.device)
            self._produced.append(self._keyframes_out)
        if self._chapters_out is not None:
            with open(self._chapters_out, "w", encoding="utf-8") as f:
                for i, t in enumerate(self.chapters):
                    h, rem = divmod(t, 3600)
                    m, s = divmod(rem, 60)
                    f.write(f"CHAPTER{i:02d}={int(h):02d}:{int(m):02d}:{s:06.3f}\n")
            self._produced.append(self._chapters_out)

    def cleanup(self):
        for p in self._produced:
            try:
                os.remove(p)
            except OSError:
                pass


def mkvextract_timecodes(mkv_path: str, stream_idx: int, output_path: str):
    """mkvextract timecodes_v2 fallback (reference demux.py:106-110)."""
    exe = shutil.which("mkvextract")
    if not exe:
        raise SyncError(
            "neither ffmpeg mkvtimestamp_v2 nor mkvextract could produce "
            f"timecodes for {mkv_path}"
        )
    subprocess.call(
        [exe, "timecodes_v2", mkv_path, f"{stream_idx}:{output_path}"]
    )


def make_keyframes(
    video, log_path: str, diff_threshold: float = 0.08,
    device: Union[str, "torch.device"] = "cuda",
) -> None:
    """Write an SCXviD-format keyframe log for a video (a path, decoded with
    OpenCV, or an ``InMemoryVideo``) with the scene-cut statistic of the
    keyframe scanner, in the JAX package's arithmetic
    (``vse_tpu/sync/demux.py::make_keyframes``): 32-frame RGB batches,
    decimated 4x (``[:n, ::4, ::4]``), the source-order gray
    (``rgb_to_gray_eager``), zero-padded to multiples of 8 x 128, the
    previous batch's last frame prepended (row 0 of its stats dropped), so
    temporal diffs span batches. K2's gray form computes the stats on
    ``device`` (``frame_stats_gray``: the kernel on the card, the plain
    version on the CPU); the diffs stay there until the pass ends. Frames
    whose mean luminance delta exceeds ``diff_threshold`` (and frame 0) are
    marked 'i'."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vse_tpu_torch.device import resolve_device
    from vse_tpu_torch.kernels.keyframe import (
        ScanParams, frame_stats_gray, padded_hw, rgb_to_gray_eager,
    )
    from vse_tpu_torch.video.decode import FrameStream, video_path

    dev = resolve_device(device)
    p = ScanParams()
    diffs: List[torch.Tensor] = []
    prev_tail = None
    for batch in FrameStream(video, batch_size=32):
        n = int(batch.valid.sum())
        small = torch.from_numpy(np.ascontiguousarray(batch.frames[:n, ::4, ::4]))
        gray = rgb_to_gray_eager(small.to(dev))
        H, W = gray.shape[1:]
        Hp, Wp = padded_hw(H, W, p)
        gray = F.pad(gray, (0, Wp - W, 0, Hp - H))
        if prev_tail is not None:
            stats = frame_stats_gray(torch.cat([prev_tail, gray]), p)[1:]
        else:
            stats = frame_stats_gray(gray, p)
        prev_tail = gray[-1:]
        diffs.append(stats[:, 2])
    if not diffs:
        raise SyncError(f"no frames decoded from {video_path(video)}")
    values = torch.cat(diffs).cpu().numpy()
    with open(log_path, "w", encoding="utf-8") as f:
        f.write("# XviD 2pass stat file 1.0\n#\n#\n")
        for i, d in enumerate(values):
            # temporal diff of frame 0 vs itself is 0 — force keyframe
            f.write("i" if (i == 0 or float(d) > diff_threshold) else "p")
            f.write("\n")
