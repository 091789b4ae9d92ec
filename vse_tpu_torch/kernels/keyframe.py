"""Keyframe / text-presence scanner: kernel K2, its plain PyTorch versions,
and the host span logic.

Per frame of a cropped subtitle band the scanner computes 4 stats:

  0: edge_energy    mean |horizontal gradient| (text = dense vertical strokes)
  1: text_cells     fraction of segment-grid cells whose edge density
                    exceeds ``moderate_threshold`` (VideoSubFinder's voting)
  2: temporal_diff  mean |frame - previous frame of the batch|
  3: mean_lum       mean luminance

``csrc/keyframe.cu`` computes them from the u8 pixels in one read, with the
gray conversion (``rgb_to_gray``, from one table of ``scan_lut``) and zero
padding fused in registers; it replaces the Pallas kernel
``vse_tpu/kernels/keyframe.py::_keyframe_kernel`` and the gray+pad program
around it. ``launch_geometry`` is its grid, kept here so the CPU tests can
check that it covers every pixel once. ``scan_stats_u8`` launches it for a
CUDA tensor and uses ``frame_stats_plain`` only for a CPU tensor.
``find_spans`` (host) turns the [T, 4] stream into keyframe spans.

K2 also takes the Pallas kernel's own input form, f32 gray [T, H, W]
(``frame_stats_pallas``), which the sync re-timer's keyframe log feeds it
(``vse_tpu_torch/sync/demux.py::make_keyframes``): ``frame_stats_gray``
launches the same kernel with its gray load (``frame_stats_gray_cuda``) for
a CUDA tensor and uses ``frame_stats_gray_plain`` for a CPU tensor.
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

# launches of the CUDA kernel by scan_stats_u8 and frame_stats_gray, both
# forms in one count (plain-version calls and direct frame_stats_cuda /
# frame_stats_gray_cuda calls are not counted)
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


_INV255 = torch.tensor(1.0 / 255.0, dtype=torch.float32)
_GRAY_W = [float(torch.tensor(w, dtype=torch.float32)) for w in (0.299, 0.587, 0.114)]


def rgb_to_gray(frames_u8: torch.Tensor) -> torch.Tensor:
    """[.., H, W, 3] uint8 -> [.., H, W] f32 luminance in [0, 1], as the
    reference's jitted scan computes it (``_scan_stats_u8_jit``): XLA turns
    ``/ 255`` into ``* f32(1/255)`` and contracts the weighted sum into
    ``fma(b', .114, fma(r', .299, g' * .587))``. Each FMA is done here in
    f64 (the product of two f32 is exact there) and rounded once to f32,
    which gives the FMA's bits on every one of the 2^24 colours."""
    x = frames_u8.float() * _INV255.to(frames_u8.device)
    wr, wg, wb = _GRAY_W
    s = x[..., 1] * torch.tensor(wg, device=x.device)
    s = (x[..., 0].double() * wr + s.double()).float()
    return (x[..., 2].double() * wb + s.double()).float()


def rgb_to_gray_eager(frames_u8: torch.Tensor) -> torch.Tensor:
    """The reference's ``rgb_to_gray`` run eagerly, in source order:
    ``(r/255*.299 + g/255*.587) + b/255*.114``. The scan does not use it;
    it is the counterpart of the eager gray of the sync path's keyframes
    (``vse_tpu/sync/demux.py``). The divisor is a tensor so that CUDA,
    like the CPU, divides (a Python-scalar divisor would be turned into a
    multiply by its reciprocal, one ulp off)."""
    f = frames_u8.float() / torch.tensor(255.0, device=frames_u8.device)
    return f[..., 0] * 0.299 + f[..., 1] * 0.587 + f[..., 2] * 0.114


def frame_stats_plain(
    frames_u8: torch.Tensor, p: ScanParams = ScanParams()
) -> torch.Tensor:
    """Plain version of K2: u8 [T, H, W, 3] -> f32 [T, 4]."""
    return frame_stats_gray_plain(rgb_to_gray(frames_u8), p)


def frame_stats_gray_plain(
    gray: torch.Tensor, p: ScanParams = ScanParams()
) -> torch.Tensor:
    """Plain version of K2's gray form: f32 gray [T, H, W], zero-padded
    here to [T, Hp, Wp] (a no-op on an already padded input) -> f32 [T, 4]
    (the reference's ``frame_stats_jnp`` on the padded frames)."""
    T, H, W = gray.shape
    Hp, Wp = padded_hw(H, W, p)
    gray = F.pad(gray, (0, Wp - W, 0, Hp - H))
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


def scan_lut() -> torch.Tensor:
    """f32 [256]: ``x' = v * f32(1/255)`` for every byte v, the operand of
    ``rgb_to_gray``'s FMAs. K2 reads its gray inputs from this table."""
    return torch.arange(256, dtype=torch.float32) * _INV255


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
    n_runs = -(-T // run)
    if n_runs > 65535:  # the grid's y dimension
        raise ValueError(f"K2 takes at most {65535 * run} frames at run {run}, got {T}")
    return Geometry(n_bands, n_strips, threads, n_parts, run, n_runs)


# per device: the gray table and the kernel's ticket counters, made at the
# first launch on it (outside any CUDA-graph capture). The tickets are zero
# between launches (the kernel resets them), so K2 launches on one device
# must not overlap: the main path issues them on one stream.
_workspace: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _consts(device: torch.device, n_runs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    ws = _workspace.get(device)
    if ws is None or ws[1].numel() < n_runs:
        lut = ws[0] if ws is not None else scan_lut().to(device)
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


def launch(frames: torch.Tensor, g: Geometry, p: ScanParams,
           partials: torch.Tensor, out: torch.Tensor) -> None:
    """One K2 launch into preallocated buffers (``alloc_outputs``): u8 RGB
    [T, H, W, 3] through the table gray, f32 [T, H, W] as gray."""
    T, H, W = frames.shape[:3]
    Hp, Wp = padded_hw(H, W, p)
    lut, tickets = _consts(frames.device, g.n_runs)
    # 16-byte loads: a strip row of u8 RGB is 48 bytes, of f32 gray 64
    if frames.dtype == torch.uint8:
        name, head, vec = "vse_keyframe_stats", (frames.data_ptr(), lut.data_ptr()), W % 16 == 0
    else:
        name, head, vec = "vse_keyframe_stats_gray", (frames.data_ptr(),), W % 4 == 0
    vec = vec and frames.data_ptr() % 16 == 0
    with _build.on_device(frames):
        status = getattr(_build.library(), name)(
            *head, T, H, W, Hp, Wp, g.n_strips, g.n_items, g.threads, g.n_parts,
            g.run, g.n_runs, int(vec), p.edge_threshold, p.moderate_threshold,
            partials.data_ptr(), tickets.data_ptr(), out.data_ptr(),
            _build.stream_of(frames),
        )
    _build.check(status, name)


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
    return _alloc_and_launch(frames_u8, p)


def _alloc_and_launch(frames: torch.Tensor, p: ScanParams) -> torch.Tensor:
    """Check what both forms share, allocate the outputs and launch."""
    if (p.segment_height, p.segment_width) != (4, 8):
        raise ValueError("K2 is built for 4 x 8 cells")
    T, H, W = frames.shape[:3]
    if H == 0 or W == 0:
        raise ValueError(f"K2 takes a non-empty frame, got {H} x {W}")
    g = launch_geometry(T, H, W, p)
    partials, out = alloc_outputs(T, g, frames.device)
    if T:
        launch(frames, g, p, partials, out)
    return out


def frame_stats_gray_cuda(
    gray: torch.Tensor, p: ScanParams = ScanParams()
) -> torch.Tensor:
    """Launch K2 on a contiguous f32 gray CUDA tensor [T, H, W], padded to
    [Hp, Wp] or not (the kernel reads the pad as zeros) (not counted)."""
    if not gray.is_cuda:
        raise ValueError("frame_stats_gray_cuda needs a CUDA tensor")
    if gray.dtype != torch.float32:
        raise TypeError(f"K2's gray form takes float32 frames, got {gray.dtype}")
    if gray.dim() != 3:
        raise ValueError(f"K2's gray form takes [T, H, W], got {tuple(gray.shape)}")
    if not gray.is_contiguous():
        raise ValueError("K2 takes a contiguous band")
    return _alloc_and_launch(gray, p)


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


def frame_stats_gray(
    gray: torch.Tensor, p: ScanParams = ScanParams()
) -> torch.Tensor:
    """K2 on f32 gray [T, H, W] -> stats [T, 4] (on the frames' device),
    the JAX package's ``frame_stats`` on the frames zero-padded to [Hp,
    Wp]. ``prev`` of frame 0 is frame 0 itself."""
    global launches
    if gray.is_cuda:
        out = frame_stats_gray_cuda(gray, p)
        launches += 1
        return out
    if gray.device.type == "cpu":
        return frame_stats_gray_plain(gray, p)
    raise ValueError(f"unsupported device {gray.device}")


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
