"""WAV loading for the audio re-timer (the port of ``vse_tpu/sync/wav.py``).

Semantics-parity rebuild of the reference's loader (reference
backend/sushi/wav.py:17-188): stream a RIFF/WAVE file, downmix channels,
nearest-neighbor resample to `sample_rate` (default 12 kHz), pad 10 s on both
sides with the edge sample, clip at 3x the positive/negative medians, and
normalize (optionally quantizing to uint8). `find_substream` performs the
windowed TM_SQDIFF_NORMED search, here via the FFT matcher
(vse_tpu_torch/sync/match.py) instead of OpenCV: the numpy matcher unless
asked for the device matcher (``use_device_matcher``, or ``VSE_SYNC_DEVICE=1``
as in the JAX package), which runs on ``device``.
"""

from __future__ import annotations

import functools
import math
import os
import struct
from typing import Optional, Tuple, Union

import numpy as np
import torch

from vse_tpu_torch.sync.common import SyncError, clip
from vse_tpu_torch.sync.match import match_template_device, match_template_numpy

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class DownmixedWav:
    """Minimal RIFF parser that downmixes to mono float32 on read."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        try:
            magic = self._f.read(4)
            if magic != b"RIFF":
                raise SyncError("File does not start with RIFF id")
            self._f.read(4)  # riff size
            if self._f.read(4) != b"WAVE":
                raise SyncError("Not a WAVE file")
            file_size = os.path.getsize(path)
            self.format_tag = None
            fmt_read = data_found = False
            while True:
                header = self._f.read(8)
                if len(header) < 8:
                    break
                cid, size = struct.unpack("<4sI", header)
                if cid == b"fmt ":
                    self._read_fmt(size)
                    fmt_read = True
                elif cid == b"data":
                    if file_size > 0xFFFFFFFF:  # broken large wav
                        self.frames_count = (file_size - self._f.tell()) // self.frame_size
                    else:
                        self.frames_count = size // self.frame_size
                    data_found = True
                    break
                else:
                    self._f.seek(size + (size & 1), 1)
            if not (fmt_read and data_found):
                raise SyncError("Invalid WAV file")
        except Exception:
            self.close()
            raise

    def _read_fmt(self, size: int):
        data = self._f.read(size + (size & 1))
        tag, channels, rate, _, block_align, bits = struct.unpack("<HHLLHH", data[:16])
        if tag not in (WAVE_FORMAT_PCM, WAVE_FORMAT_EXTENSIBLE, WAVE_FORMAT_IEEE_FLOAT):
            raise SyncError(f"unknown WAV format: {tag}")
        self.format_tag = tag
        self.channels_count = channels
        self.framerate = rate
        self.sample_width = (bits + 7) // 8
        self.frame_size = channels * self.sample_width

    def readframes(self, count: int) -> np.ndarray:
        data = self._f.read(count * self.frame_size)
        if self.format_tag == WAVE_FORMAT_IEEE_FLOAT and self.sample_width == 4:
            unpacked = np.frombuffer(data, np.float32).astype(np.float32)
        elif self.sample_width == 2:
            unpacked = np.frombuffer(data, np.int16).astype(np.float32)
        elif self.sample_width == 3:
            raw = np.frombuffer(data, np.int8)
            n = len(raw) // 3
            out = np.zeros(n, np.int16)
            view = out.view(np.int8).reshape(n, 2)
            view[:, 0] = raw[1::3][:n]
            view[:, 1] = raw[2::3][:n]
            unpacked = out.astype(np.float32)
        else:
            raise SyncError(f"Unsupported sample width: {self.sample_width}")
        if self.channels_count == 1:
            return unpacked
        n = len(unpacked) // self.channels_count
        return unpacked[: n * self.channels_count].reshape(
            n, self.channels_count
        ).mean(axis=1)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _nearest_resample(x: np.ndarray, new_len: int) -> np.ndarray:
    """Nearest-neighbor 1-D resample (the reference resamples with
    cv2.resize INTER_NEAREST, wav.py:135)."""
    if new_len == len(x):
        return x
    idx = np.minimum(
        (np.arange(new_len) * (len(x) / new_len) + 0.5).astype(np.int64),
        len(x) - 1,
    )
    return x[idx]


class WavStream:
    PADDING_SECONDS = 10

    def __init__(self, path: str, sample_rate: int = 12000, sample_type: str = "uint8",
                 use_device_matcher: Optional[bool] = None,
                 device: Union[str, torch.device] = "cuda"):
        if sample_type not in ("float32", "uint8"):
            raise SyncError("sample_type must be uint8 or float32")
        stream = DownmixedWav(path)
        try:
            total_seconds = stream.frames_count / float(stream.framerate)
            self.sample_count = math.ceil(total_seconds * sample_rate)
            self.sample_rate = sample_rate
            self.padding_size = self.PADDING_SECONDS * sample_rate
            data = np.empty(self.sample_count + 2 * self.padding_size, np.float32)
            rate = stream.framerate
            down = sample_rate / float(rate)
            written = self.padding_size
            seconds_read = 0
            while seconds_read < total_seconds:
                chunk = stream.readframes(int(rate))
                if len(chunk) == 0:
                    break
                new_len = int(round(len(chunk) * down))
                data[written : written + new_len] = _nearest_resample(chunk, new_len)
                written += new_len
                seconds_read += 1
            # pad both sides with the edge sample
            data[: self.padding_size].fill(data[self.padding_size])
            data[written:].fill(data[written - 1])
            # clip at 3x medians, then normalize to [0, 1]
            max_value = float(np.median(data[data >= 0])) * 3
            min_value = float(np.median(data[data <= 0])) * 3
            np.clip(data, min_value, max_value, out=data)
            data -= min_value
            rng = max(max_value - min_value, 1e-9)
            data /= rng
            if sample_type == "uint8":
                data = (data * 255.0 + 0.5).astype(np.uint8).astype(np.float32)
            self.data = data
        except SyncError:
            raise
        except Exception as e:
            raise SyncError(f"Error while loading {path}: {e}")
        finally:
            stream.close()
        if use_device_matcher is None:
            # opt-in, as in the JAX package: per-group matches are single
            # small FFTs, for which host numpy is latency-optimal; the device
            # matcher pays an upload and a download per call
            use_device_matcher = os.environ.get("VSE_SYNC_DEVICE", "0") == "1"
        self._match = (
            functools.partial(match_template_device, device=torch.device(device))
            if use_device_matcher else match_template_numpy
        )

    @property
    def duration_seconds(self) -> float:
        return self.sample_count / self.sample_rate

    def _sample_for_time(self, t: float) -> int:
        return int(self.sample_rate * t) + self.padding_size

    def get_substream(self, start: float, end: float) -> np.ndarray:
        return self.data[self._sample_for_time(start) : self._sample_for_time(end)]

    def find_substream(self, pattern: np.ndarray, window_center: float,
                       window_size: float) -> Tuple[float, float]:
        """Best (score, time) of `pattern` within +-window_size of
        window_center (reference wav.py:176-188)."""
        start_time = clip(window_center - window_size, -self.PADDING_SECONDS,
                          self.duration_seconds)
        end_time = clip(window_center + window_size, 0,
                        self.duration_seconds + self.PADDING_SECONDS)
        start_sample = self._sample_for_time(start_time)
        end_sample = self._sample_for_time(end_time) + len(pattern)
        src = self.data[start_sample : min(end_sample, len(self.data))]
        score, offset = self._match(src, pattern)
        return score, start_time + offset / float(self.sample_rate)
