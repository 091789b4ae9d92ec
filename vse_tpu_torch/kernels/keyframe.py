"""Keyframe / text-presence scanner: kernel K2, its plain PyTorch version,
and the host span logic.

Per frame of a cropped uint8 subtitle band the scanner computes 4 stats:

  0: edge_energy    mean |horizontal gradient| (text = dense vertical strokes)
  1: text_cells     fraction of segment-grid cells whose edge density
                    exceeds ``moderate_threshold`` (VideoSubFinder's voting)
  2: temporal_diff  mean |frame - previous frame of the batch|
  3: mean_lum       mean luminance

``csrc/keyframe.cu`` computes them from the u8 pixels in one read, with the
gray conversion (table lookups, ``gray_lut``) and zero padding fused in
registers; it replaces the Pallas kernel
``vse_tpu/kernels/keyframe.py::_keyframe_kernel`` and the gray+pad program
around it. ``launch_geometry`` is its grid, kept here so the CPU tests can
check that it covers every pixel once. ``scan_stats_u8`` launches it for a
CUDA tensor and uses ``frame_stats_plain`` only for a CPU tensor.
``find_spans`` (host) turns the [T, 4] stream into keyframe spans.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vse_tpu_torch.kernels import _build

# launches of the CUDA kernel by scan_stats_u8 (plain-version calls and
# direct frame_stats_cuda calls are not counted)
launches = 0


@dataclass(frozen=True)
class ScanParams:
    """Scanner tunables (named after the VSF general.cfg knobs they mirror)."""

    segment_width: int = 8
    segment_height: int = 4
    moderate_threshold: float = 0.4
    # edge magnitude (in [0,1] luminance units) for a pixel to count as edge
    edge_threshold: float = 0.08
    # min text-cell fraction for a frame to count as "has text"
    text_cell_frac: float = 0.02
    # frames shorter than this are dropped (VSF sub_frame_length)
    sub_frame_length: int = 6
    # temporal diff (mean abs lum delta) that splits a span
    change_threshold: float = 0.03


def padded_hw(H: int, W: int, p: ScanParams = ScanParams()) -> Tuple[int, int]:
    """The reference's pad rule: H up to a multiple of lcm(8, segment_height),
    W up to a multiple of lcm(128, segment_width). Every mean is taken over
    this padded area."""
    mh = (p.segment_height * 8) // math.gcd(p.segment_height, 8)
    mw = (p.segment_width * 128) // math.gcd(p.segment_width, 128)
    return H + (-H) % mh, W + (-W) % mw


def rgb_to_gray(frames_u8: torch.Tensor) -> torch.Tensor:
    """[.., H, W, 3] uint8 -> [.., H, W] f32 luminance in [0, 1], in the
    reference's order of operations. The divisor is a tensor so that CUDA,
    like the CPU, divides (a Python-scalar divisor would be turned into a
    multiply by its reciprocal, one ulp off)."""
    f = frames_u8.float() / torch.tensor(255.0, device=frames_u8.device)
    return f[..., 0] * 0.299 + f[..., 1] * 0.587 + f[..., 2] * 0.114


def frame_stats_plain(
    frames_u8: torch.Tensor, p: ScanParams = ScanParams()
) -> torch.Tensor:
    """Plain version of K2: u8 [T, H, W, 3] -> f32 [T, 4]."""
    T, H, W, _ = frames_u8.shape
    Hp, Wp = padded_hw(H, W, p)
    gray = F.pad(rgb_to_gray(frames_u8), (0, Wp - W, 0, Hp - H))
    prev = torch.cat([gray[:1], gray[:-1]], dim=0)
    gx = (gray - torch.roll(gray, 1, dims=2)).abs()
    gx[:, :, 0] = 0.0
    edges = (gx > p.edge_threshold).float()
    sh, sw = p.segment_height, p.segment_width
    cells = edges.reshape(T, Hp // sh, sh, Wp // sw, sw).sum(dim=(2, 4))
    density = cells / float(sh * sw)
    # the reference's mean is count * f32(1 / n_cells) (XLA turns the divide
    # by a constant into a multiply by its f32 reciprocal); kept exact here
    one = torch.ones((), device=gray.device)
    inv_cells = one / (cells.shape[1] * cells.shape[2])
    text_cells = (density > p.moderate_threshold).sum(dim=(1, 2)).float() * inv_cells
    return torch.stack(
        [
            gx.mean(dim=(1, 2)),
            text_cells,
            (gray - prev).abs().mean(dim=(1, 2)),
            gray.mean(dim=(1, 2)),
        ],
        dim=1,
    )


def gray_lut() -> torch.Tensor:
    """f32 [3, 256]: the per-byte terms of ``rgb_to_gray`` (``v / 255 * w``
    for the weights 0.299, 0.587, 0.114), computed with the same f32
    operations, so that ``(lut[0][r] + lut[1][g]) + lut[2][b]`` in f32 is
    ``rgb_to_gray`` bit for bit. K2 looks gray up in these tables."""
    f = torch.arange(256, dtype=torch.float32) / torch.tensor(255.0)
    return torch.stack([f * 0.299, f * 0.587, f * 0.114])


# K2's grid (csrc/keyframe.cu): a strip is one cell row by STRIP pixels and
# four consecutive threads own its four rows; a block takes threads / 4
# consecutive strips (row-major over cell rows, then strips) for `run`
# consecutive frames
STRIP = 16
K2_THREADS = 256
K2_RUN_MAX = 8  # RUN_MAX in csrc/keyframe.cu
K2_MIN_BLOCKS = 264  # two blocks for each of an H100's 132 SMs


@dataclass(frozen=True)
class Geometry:
    n_bands: int  # cell rows holding real pixels: ceil(H / segment_height)
    n_strips: int  # strips per row, up to the pad column x = W when W < Wp
    threads: int
    n_parts: int  # blocks per frame run
    run: int  # frames a block walks
    n_runs: int

    @property
    def n_items(self) -> int:
        return self.n_bands * self.n_strips

    @property
    def strips_per_block(self) -> int:
        return self.threads // 4

    def strips(self, part: int) -> Tuple[np.ndarray, np.ndarray]:
        """(first row, first column) of each strip that block ``part`` of a
        frame run owns, in the kernel's thread order."""
        item = part * self.strips_per_block + np.arange(self.strips_per_block)
        item = item[item < self.n_items]
        band, strip = np.divmod(item, self.n_strips)
        return band * 4, strip * STRIP

    def frames(self, run_idx: int, T: int) -> range:
        return range(run_idx * self.run, min(T, (run_idx + 1) * self.run))


@functools.lru_cache(maxsize=64)
def launch_geometry(
    T: int, H: int, W: int, p: ScanParams = ScanParams(),
    threads: int = K2_THREADS, run: Optional[int] = None,
) -> Geometry:
    """K2's grid for a [T, H, W, 3] band: (n_parts, n_runs) blocks. Unless
    given, ``run`` is the longest (up to K2_RUN_MAX) that still leaves
    K2_MIN_BLOCKS blocks, or 1."""
    if not (threads % 32 == 0 and 32 <= threads <= 256):
        raise ValueError(f"K2 takes 32..256 threads in whole warps, got {threads}")
    _, Wp = padded_hw(H, W, p)
    n_bands = -(-H // p.segment_height)
    n_strips = -(-min(W + 1, Wp) // STRIP)
    n_parts = -(-(n_bands * n_strips) // (threads // 4))
    if run is None:
        run = K2_RUN_MAX
        while run > 1 and n_parts * -(-T // run) < K2_MIN_BLOCKS:
            run //= 2
    if not 1 <= run <= K2_RUN_MAX:
        raise ValueError(f"K2 takes 1 <= run <= {K2_RUN_MAX}, got {run}")
    return Geometry(n_bands, n_strips, threads, n_parts, run, -(-T // run))


# per device: the gray tables and the kernel's ticket counters, made at the
# first launch on it (outside any CUDA-graph capture). The tickets are zero
# between launches (the kernel resets them), so K2 launches on one device
# must not overlap: the main path issues them on one stream.
_workspace: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _consts(device: torch.device, n_runs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    ws = _workspace.get(device)
    if ws is None or ws[1].numel() < n_runs:
        lut = ws[0] if ws is not None else gray_lut().reshape(-1).to(device)
        ws = (lut, torch.zeros(max(n_runs, 1024), dtype=torch.int32, device=device))
        _workspace[device] = ws
    return ws


def alloc_outputs(T: int, g: Geometry, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One allocation for K2's f64 partial sums [T, n_parts, 4] and its
    f32 output [T, 4] (a view into it)."""
    n_part = T * g.n_parts * 4 * 8
    buf = torch.empty(n_part + T * 16, dtype=torch.uint8, device=device)
    partials = buf[:n_part].view(torch.float64)
    return partials, buf[n_part:].view(torch.float32).view(T, 4)


def launch(frames_u8: torch.Tensor, g: Geometry, p: ScanParams,
           partials: torch.Tensor, out: torch.Tensor) -> None:
    """One K2 launch into preallocated buffers (``alloc_outputs``)."""
    T, H, W, _ = frames_u8.shape
    Hp, Wp = padded_hw(H, W, p)
    lut, tickets = _consts(frames_u8.device, g.n_runs)
    vec = W % 16 == 0 and frames_u8.data_ptr() % 16 == 0
    with _build.on_device(frames_u8):
        status = _build.library().vse_keyframe_stats(
            frames_u8.data_ptr(), lut.data_ptr(), T, H, W, Hp, Wp,
            g.n_strips, g.n_items, g.threads, g.n_parts, g.run, g.n_runs,
            int(vec), p.edge_threshold, p.moderate_threshold,
            partials.data_ptr(), tickets.data_ptr(), out.data_ptr(),
            _build.stream_of(frames_u8),
        )
    _build.check(status, "vse_keyframe_stats")


def frame_stats_cuda(
    frames_u8: torch.Tensor, p: ScanParams = ScanParams()
) -> torch.Tensor:
    """Launch K2 on a contiguous u8 CUDA band [T, H, W, 3] (not counted)."""
    if not frames_u8.is_cuda:
        raise ValueError("frame_stats_cuda needs a CUDA tensor")
    if frames_u8.dtype != torch.uint8:
        raise TypeError(f"K2 takes uint8 frames, got {frames_u8.dtype}")
    if frames_u8.dim() != 4 or frames_u8.shape[-1] != 3:
        raise ValueError(f"K2 takes [T, H, W, 3], got {tuple(frames_u8.shape)}")
    if not frames_u8.is_contiguous():
        raise ValueError("K2 takes a contiguous band")
    if (p.segment_height, p.segment_width) != (4, 8):
        raise ValueError("K2 is built for 4 x 8 cells")
    T, H, W, _ = frames_u8.shape
    if H == 0 or W == 0:
        raise ValueError(f"K2 takes a non-empty frame, got {H} x {W}")
    g = launch_geometry(T, H, W, p)
    partials, out = alloc_outputs(T, g, frames_u8.device)
    if T:
        launch(frames_u8, g, p, partials, out)
    return out


def scan_stats_u8(
    frames_u8: torch.Tensor, p: ScanParams = ScanParams()
) -> torch.Tensor:
    """Scan stage on a uint8 band [T, H, W, 3] -> stats [T, 4] (on the
    band's device). ``prev`` of frame 0 is frame 0 itself: callers scanning
    in batches of 32 get a zero diff every 32nd frame, as the reference."""
    global launches
    if frames_u8.is_cuda:
        out = frame_stats_cuda(frames_u8, p)
        launches += 1
        return out
    if frames_u8.device.type == "cpu":
        return frame_stats_plain(frames_u8, p)
    raise ValueError(f"unsupported device {frames_u8.device}")


@dataclass
class Span:
    start_frame: int  # original frame numbers
    end_frame: int


def find_spans(
    stats: np.ndarray,
    frame_nos: np.ndarray,
    p: ScanParams = ScanParams(),
) -> List[Span]:
    """[T, 4] stats + original frame numbers -> keyframe spans.

    A frame "has text" when its text-cell fraction exceeds ``text_cell_frac``.
    A span closes when text disappears or the temporal diff spikes. Spans
    shorter than ``sub_frame_length`` scanned frames are dropped. The spike
    threshold adapts to the video's baseline motion (median temporal diff).
    """
    has_text = stats[:, 1] > p.text_cell_frac
    baseline = float(np.median(stats[:, 2])) if len(stats) else 0.0
    spike_thresh = max(p.change_threshold, 2.5 * baseline)
    diff_spike = stats[:, 2] > spike_thresh
    spans: List[Span] = []
    start = None
    for t in range(len(stats)):
        if has_text[t]:
            if start is None:
                start = t
            elif diff_spike[t]:
                if t - start >= p.sub_frame_length:
                    spans.append(Span(int(frame_nos[start]), int(frame_nos[t - 1])))
                start = t
        else:
            if start is not None:
                if t - start >= p.sub_frame_length:
                    spans.append(Span(int(frame_nos[start]), int(frame_nos[t - 1])))
                start = None
    if start is not None and len(stats) - start >= p.sub_frame_length:
        spans.append(Span(int(frame_nos[start]), int(frame_nos[len(stats) - 1])))
    return spans
