#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vse_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each timed; any failure raises and the script exits non-zero:

1. environment: the card's name and power limit (nvidia-smi), torch/CUDA
   versions, and whether OpenCV and ninja exist (printed only, never needed);
2. build: the CUDA kernels of ``vse_tpu_torch/csrc`` with one nvcc call;
3. kernel parity on the card: K1 (greedy CTC decode, on f32, f16 and bf16
   logits, at en's C = 69, ch's C = 21,060 and japan's C = 21,249, and on
   f32 at the ten non-CJK heads' C, 83 to 298, on the fused path's 8- and
   16-lane steps) and K2 (keyframe stats, on en's, ch's and each family's
   fixture bands) against their plain
   PyTorch versions on the same inputs, twice (the kernels are
   deterministic); K2 also on the
   noisy band (``vse_tpu_torch.video.synth.noisy_band``, rebuilt from its
   seed), against the JAX package's stats of it committed in
   ``assets/smoke/noisy_band.npz``; and each kernel's times at the main
   path's shapes: ``device_us``, its own device time (100 launches into
   preallocated buffers captured in a CUDA graph, replayed between CUDA
   events), ``wall_us``, the host-clock cost of one wrapper call as the main
   path makes it (200 calls, then a synchronize), ``loop_us`` (CUDA events
   around 100 back-to-back launches from Python: host-bound when the kernel
   is shorter than a call), its device-memory bound and share of it, the
   plain version's wall time and, for K1, the library composite
   ``torch.max`` + ``torch.logsumexp`` (a yardstick the port never calls);
4. the main path, ``extract --area --mode fast`` for ``en`` with the
   default config (word segmentation on) through
   ``SubtitleExtractor(...).run()`` on a 20 s 1280x720 25 fps clip composed
   in memory from ``vse_tpu_torch/assets/smoke``, with the real PP-OCRv3
   mobile det weights and the exported en rec head: the keyframe strategy,
   the scan fed by ``device_prefetch``. The SRT must equal the committed
   reference (the JAX package's CLI on the CPU for the same frames), K2 must
   launch once per 32-frame batch and K1 at least once;
5. the fps path, ``extract`` with no area and the default config, on two
   no-area clips: the same cues, a corner watermark and a short scene-text
   line, once with the keyframe clip's cue lengths (the JAX package's auto
   watermark policy drops those subtitles, ROADMAP fault 6) and once with
   cues short enough that the subtitles survive the filters. The fps
   strategy fed by ``device_prefetch``, the filters, word segmentation.
   Every OCR line before the filters must equal the JAX package's (the same
   frame and text, a box within 2 px, a score within ``SCORE_ATOL``), the
   SRT must equal its committed reference, K1 must launch once per OCR
   chunk and K2 never;
6. the default language, ch, with its 21,060-class head, so that every OCR
   chunk goes through K1's two-launch large-C path on real logits: the
   keyframe strategy on ``recipe_ch.json`` (an area; the SRT equal to
   ``reference_ch.srt``, K2 once per 32-frame batch, K1 at least once) and
   the fps strategy on ``recipe_ch_fps_short.json`` (no area; every line
   before the filters and the SRT held as in phase 5). It prints the memory
   that the CUDA graphs' private pools hold (each rec graph keeps a
   [64, 80, 21060] f32 output);
7. the ten non-CJK script families (latin, cyrillic, devanagari, arabic,
   korean, el, ta, te, ka, th), each with its own engine on its exported
   head: the keyframe strategy on the family's clip of
   ``recipe_scripts.json``; the SRT must equal the JAX CLI's and every OCR
   line of every keyframe sample the JAX extractor's (the same frame and
   text, a box within 2 px, where the box is equal a score within
   ``SCORE_ATOL``; ``reference_scripts.json``), but for the reads that
   ``FAULT_11`` lists (ROADMAP fault 11); K2 must launch once per 32-frame
   batch and K1 once per OCR chunk. Each engine and its CUDA-graph pools
   are freed before the next;
8. the last two CJK families, japan (C = 21,249, whose unaligned rows take
   K1's two-launch path on the main path) and chinese_cht (C = 21,060),
   each with its own engine, on its keyframe clip of
   ``recipe_scripts.json``, held as in phase 7 (the JAX CLI's SRT, every
   line's frame, text, box and score, but for ``FAULT_11``); K2 once per
   32-frame batch, K1 once per OCR chunk, through the two-launch path; the
   CUDA-graph pools printed after each;
9. the batch surface: ``extract_many`` with the keyframe strategy on the
   en keyframe clip and the short-cue clip given the same area (their
   samples pooled into shared OCR chunks: K2 16 times a video, K1 once a
   chunk, ceil(samples / frame_batch) chunks) and with the fps strategy on
   the two no-area clips (their sampled frames interleaved into shared
   batches), each video's SRT equal to the JAX package's ``extract_many``
   on the same clips (``reference_many.json``); then one queue of two
   tasks (the keyframe clip with its area, the short-cue clip without)
   through ``ExtractionService`` in thread isolation, each SRT equal to its
   single-video reference. Process isolation is tested on the CPU only
   (``tests/test_torch_isolation.py``): a child needs a video file, and
   this machine is not promised a decoder for one;
10. the sync re-timer on its job of ``vse_tpu_torch/sync/synth.py`` (made
   from the seed in ``assets/smoke/reference_sync.json``, whose WAVs'
   sha256 must match): two 24-minute 12 kHz WAVs, the second with a 3.2 s
   insert at 11 minutes, a script of ~300 cues, and two 20 s 720p
   in-memory clips with scene cuts. ``make_keyframes(..., device="cuda")``
   writes each clip's SCXviD log through K2's f32-gray form (16 launches a
   clip, [33, 184, 384] but the first [32, ...] and the last); each log
   must equal the JAX package's, and each launch's stats its plain
   version's (``text_cells`` exact, the rest within rtol 1e-5; a second
   launch bit-equal). Then ``vse_tpu_torch.sync.run`` with those logs
   (``--src-fps 25 --dst-fps 25 --kf-mode all``), once with the numpy
   matcher and once with the device matcher (``VSE_SYNC_DEVICE=1``,
   ``torch.fft`` on the card): each SRT must equal the JAX runner's. It
   prints where the pass's time goes (WAV loads, matcher calls) and times
   the gray form at [33, 184, 384] (``at_sync_gray``). The GUI is tested on
   the CPU only: its extraction is phase 9's service, and its HTTP surface
   needs a video file and OpenCV.

Each path of phases 4-6 runs twice (cold, warm), and so do latin, arabic,
korean (phase 7) and japan (phase 8) (the other families once), with the
launch counts set to 0 just before each run and read just after;
``launches_by_path`` holds the last run's of each path (phase 10's paths:
``sync_keyframes_src``, ``sync_keyframes_dst``, ``sync_numpy``,
``sync_device``). Each timed row (a
kernel's top-level numbers, and ``at_c293``, ``at_c21060``, ``at_c21249``,
``at_ch_area`` and ``at_scripts``) names the paths that run the kernel at
its shape (``row_paths``: en's C = 69 and 1280-wide band with phase 9's
paths, latin's C = 293, ch's and chinese_cht's C = 21,060, japan's C =
21,249, ch's 400-wide band, the families' band widths, the sync path's
gray frames) and their launches
(``row_launches``); ``launches`` is the sum over all paths. The line before the last lists the kernels as JSON; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the package
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
GRAPH_LAUNCHES = 100  # kernel launches captured in one CUDA graph
SCORE_ATOL = 0.005  # an OCR line's score against the JAX package's
REPLAYS = 5
WALL_CALLS = 200
# ROADMAP fault 11: the det's convolutions sum in another order than XLA's
# on the CPU (cuDNN here), which moves a det box by up to 2 px at the
# families' band shape, or keeps it as an integer but not as a float; a
# moved crop moves the line's score, and on a marginal glyph its read. What
# the port reads otherwise than the JAX package, on the CPU or on the card
# (the JAX read stays acceptable): a cue of the SRT (its index, the port's
# text), a line's text, and the scores of lines whose box is equal.
FAULT_11 = {
    "latin": {"score_atol": 0.03},  # 0.0226 on the CPU, 0.0266 on the card
    # te's second cue gains a 22 px fragment, 'ష', whose box is 1 px wider
    # than the JAX package's and scores 0.836 against 0.323 (gate: 0.75)
    "te": {"cues": {2: "ధన్యఙాద ష"}, "score_atol": 0.012},
    "th": {"cues": {2: "ขอบคูณ"}, "texts": {"ขอบคุณ": "ขอบคูณ"}},  # on the CPU
    # the 21k-class heads, all boxes equal: the rec's own sums move a
    # garbage read under the drop score (japan: 彩小所对 0.3094 in JAX,
    # 彩小所乡对 0.2587) and chinese_cht's scores by 0.0058 (on the CPU)
    "japan": {"texts": {"彩小所对": "彩小所乡对"}, "score_atol": 0.051},
    "chinese_cht": {"score_atol": 0.006},
}
# the ten non-CJK heads' class counts, with the blank
SCRIPT_CLASSES = (83, 98, 99, 111, 139, 147, 162, 201, 293, 298)
# the families whose keyframe path runs cold and then warm (latin serves 43
# languages; japan's is K1's row at C = 21,249); the others run once
SCRIPT_WARM = ("latin", "arabic", "korean", "japan")


def phase(name: str, t0: float) -> None:
    print(f"[phase] {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def device_us(fn, n: int = GRAPH_LAUNCHES, replays: int = REPLAYS) -> float:
    """A kernel's own device time: ``fn`` (one launch into preallocated
    buffers) captured ``n`` times back to back in a CUDA graph, the graph
    replayed between CUDA events; median over ``replays`` of elapsed / n.
    The graph leaves no host work between the launches."""
    import torch

    fn()  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / n)
    del graph
    return statistics.median(times)


def loop_us(fn, n: int = GRAPH_LAUNCHES) -> float:
    """CUDA events around ``n`` back-to-back calls of ``fn`` from Python,
    elapsed / n: the device time when the kernel outlasts one call's host
    work, the host's cost per call when it does not."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / n


def wall_us(fn, n: int = WALL_CALLS) -> float:
    """Host-clock cost of one call as a caller makes it: ``n`` calls, then
    a synchronize, over n."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / n


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want, rtol, atol):
    import torch

    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        err = (got - want).abs().max().item()
        raise AssertionError(f"{name}: max abs err {err} beyond rtol {rtol} atol {atol}")
    return (got - want).abs().max().item() if got.numel() else 0.0


def k1_logits(N, T, C, seed):
    """Random logits with exact ties (the max copied to a later and to an
    earlier class) and all-blank rows (class 0 dominant at every step)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, T, C), generator=g) * 4.0
    best = x.argmax(-1)
    top = x.max(-1).values
    x[0, :, :].scatter_(1, ((best[0] + 7) % C)[:, None], top[0][:, None])
    x[1, :, :].scatter_(1, ((best[1] + C - 3) % C)[:, None], top[1][:, None])
    x[2:5, :, 0] = x[2:5].max(-1).values + 5.0
    return x.cuda()


def timing_row(label, kernel_fn, wall_fn, plain_fn, n_bytes, n_ops, library_fn=None):
    """The timing numbers of one kernel at one shape (see README: device_us
    against wall_us)."""
    dev = device_us(kernel_fn)
    bnd, by = bound_ms(n_bytes, n_ops)
    row = dict(
        device_us=dev, loop_us=loop_us(kernel_fn), wall_us=wall_us(wall_fn),
        plain_ms=wall_us(plain_fn, n=20) / 1e3, bound_ms=bnd, bound_by=by,
        share_of_bound=bnd * 1e3 / dev,
        library_ms=device_us(library_fn) / 1e3 if library_fn else None,
    )
    lib = f", library {row['library_ms'] * 1e3:.2f} us" if library_fn else ""
    print(f"{label}: device {dev:.3f} us (C-entry loop {row['loop_us']:.3f} us), "
          f"wall {row['wall_us']:.3f} us a call, bound {bnd * 1e3:.3f} us by {by} "
          f"({row['share_of_bound']:.1%} of it), plain {row['plain_ms'] * 1e3:.1f} us"
          f"{lib}", flush=True)
    return row


def kernel_parity():
    import torch

    import numpy as np

    from vse_tpu_torch.kernels import ctc_decode as k1
    from vse_tpu_torch.kernels import keyframe as k2
    from vse_tpu_torch.video.synth import (
        CJK_FAMILIES, SCRIPT_FAMILIES, SMOKE_FIXTURE, compose_frames, load_fixture,
        load_script_fixture, noisy_band,
    )

    rows = {}
    # K1 at the main paths' shapes, [8 frames x 8 boxes, 80, C]: en's C = 69
    # (logits warm in L2), ch's 21,060 (431 MB: cold in the 50 MB L2, rows
    # 16-byte aligned) and japan's 21,249 (rows not aligned)
    k1_err = 0.0
    for key, C, seed in (("K1", 69, 0), ("K1_c21060", 21060, 2), ("K1_c21249", 21249, 1)):
        N, T = 64, 80
        x = k1_logits(N, T, C, seed)
        ids, mask, sc = k1.greedy_decode_cuda(x)
        ids_p, mask_p, sc_p = k1.collapse(*k1.argmax_lse_plain(x))
        if not (torch.equal(ids, ids_p) and torch.equal(mask, mask_p)):
            raise AssertionError(f"K1 {N,T,C}: ids/mask differ from the plain version")
        if not torch.all(sc[2:5] == 1.0):
            raise AssertionError("K1: an all-blank row must score 1.0")
        k1_err = max(k1_err, check_close(f"K1 {N,T,C} scores", sc, sc_p, 1e-5, 1e-6))
        again = k1.greedy_decode_cuda(x)
        if not all(torch.equal(a, b) for a, b in zip((ids, mask, sc), again)):
            raise AssertionError(f"K1 {N,T,C}: two runs differ")
        fused = k1.decode_plan(T, C)[0]
        launches = "1 launch" if fused else "2 launches"
        half_rows = {}
        for dt in (torch.float16, torch.bfloat16) if key != "K1_c21060" else ():
            xh = x.to(dt)
            got = k1.greedy_decode_cuda(xh)
            want = k1.collapse(*k1.argmax_lse_plain(xh))
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"K1 {N,T,C} {dt}: ids/mask differ from the plain version")
            k1_err = max(k1_err, check_close(f"K1 {N,T,C} {dt} scores", got[2], want[2],
                                             1e-5, 1e-6))
            bh = k1.alloc_outputs(N, T, x.device)
            half_rows[str(dt)[6:]] = timing_row(
                f"K1 [{N},{T},{C}] {str(dt)[6:]} ({launches}; ids/mask exact, scores "
                "within rtol 1e-5)",
                lambda: k1.launch(xh, *bh), lambda: k1.ctc_greedy_decode(xh),
                lambda: k1.collapse(*k1.argmax_lse_plain(xh)),
                N * T * C * 2 + N * T * 5 + N * 4, 4.0 * N * T * C,
                library_fn=lambda: (torch.max(xh, -1), torch.logsumexp(xh, -1)),
            )
            del xh
        bufs = k1.alloc_outputs(N, T, x.device)
        row = timing_row(
            f"K1 [{N},{T},{C}] ({launches}; ids/mask exact, deterministic)",
            lambda: k1.launch(x, *bufs), lambda: k1.ctc_greedy_decode(x),
            lambda: k1.collapse(*k1.argmax_lse_plain(x)),
            N * T * C * 4 + N * T * 5 + N * 4, 4.0 * N * T * C,
            library_fn=lambda: (torch.max(x, -1), torch.logsumexp(x, -1)),
        )
        row.update(shape=[N, T, C], half=half_rows)
        rows[key] = row
        del x
        torch.cuda.empty_cache()
    # the ten non-CJK heads, on the fused path (8 lanes a step for C <= 128,
    # 16 up to 512); latin's C = 293 is timed, its 6 MB of logits warm in L2
    # as on the main path
    for C in SCRIPT_CLASSES:
        N, T = 64, 80
        x = k1_logits(N, T, C, seed=C)
        ids, mask, sc = k1.greedy_decode_cuda(x)
        ids_p, mask_p, sc_p = k1.collapse(*k1.argmax_lse_plain(x))
        if not (torch.equal(ids, ids_p) and torch.equal(mask, mask_p)):
            raise AssertionError(f"K1 {N,T,C}: ids/mask differ from the plain version")
        if not all(torch.equal(a, b) for a, b in zip((ids, mask, sc), k1.greedy_decode_cuda(x))):
            raise AssertionError(f"K1 {N,T,C}: two runs differ")
        k1_err = max(k1_err, check_close(f"K1 {N,T,C} scores", sc, sc_p, 1e-5, 1e-6))
        fused, lanes, _ = k1.decode_plan(T, C)
        print(f"K1 [{N},{T},{C}] f32: fused {fused}, {lanes} lanes a step; ids/mask exact, "
              "scores within rtol 1e-5, deterministic", flush=True)
        if C == 293:
            bufs = k1.alloc_outputs(N, T, x.device)
            row = timing_row(
                f"K1 [{N},{T},{C}] (1 launch, {lanes} lanes a step)",
                lambda x=x, bufs=bufs: k1.launch(x, *bufs), lambda x=x: k1.ctc_greedy_decode(x),
                lambda x=x: k1.collapse(*k1.argmax_lse_plain(x)),
                N * T * C * 4 + N * T * 5 + N * 4, 4.0 * N * T * C,
                library_fn=lambda x=x: (torch.max(x, -1), torch.logsumexp(x, -1)),
            )
            row.update(shape=[N, T, C], lanes=lanes)
            rows["K1_c293"] = row
        del x
    rows["K1"]["max_abs_err"] = k1_err

    # K2 on the fixtures' text bands (en's [32, 104, 1280, 3] and ch's
    # [32, 104, 400, 3], its area narrowed around the cues; warm in L2 as
    # after their upload), on random pixels at en's shape, and on a ragged
    # shape
    def fixture_band(recipe_name):
        bands, recipe = load_fixture(recipe=recipe_name)
        y0, y1, x0, x1 = recipe["area"]
        clip = compose_frames(bands, recipe, n_frames=64)
        return torch.from_numpy(clip[32:64, y0:y1, x0:x1].copy()).cuda()

    band = fixture_band("recipe.json")
    band_ch = fixture_band("recipe_ch.json")
    # each family's band, one per area width that en and ch lack
    script_bands = {}
    for family in SCRIPT_FAMILIES + CJK_FAMILIES:
        bands, recipe = load_script_fixture(family)
        y0, y1, x0, x1 = recipe["area"]
        if x1 - x0 not in (1280, 400) and x1 - x0 not in script_bands:
            clip = compose_frames(bands, recipe, n_frames=64)
            script_bands[x1 - x0] = (family, torch.from_numpy(
                clip[32:64, y0:y1, x0:x1].copy()).cuda())
    g = torch.Generator().manual_seed(7)
    cases = [
        ("fixture band", band),
        ("ch fixture band", band_ch),
        *((f"{fam} fixture band", b) for fam, b in script_bands.values()),
        ("random", torch.randint(0, 256, tuple(band.shape), generator=g,
                                 dtype=torch.uint8).cuda()),
        ("ragged", torch.randint(0, 256, (32, 37, 301, 3), generator=g,
                                 dtype=torch.uint8).cuda()),
    ]
    k2_err = 0.0
    for label, fr in cases:
        got = k2.frame_stats_cuda(fr)
        want = k2.frame_stats_plain(fr)
        if not torch.equal(got[:, 1], want[:, 1]):
            raise AssertionError(f"K2 {label}: text_cells differ")
        if not torch.all(got[::32, 2] == 0):
            raise AssertionError(f"K2 {label}: the batch's first diff must be 0")
        if not torch.equal(got, k2.frame_stats_cuda(fr)):
            raise AssertionError(f"K2 {label}: two runs differ")
        k2_err = max(k2_err, check_close(f"K2 {label}", got, want, 1e-5, 1e-6))
        print(f"K2 {label} {list(fr.shape)}: stats within rtol 1e-5, text_cells "
              f"exact, deterministic (first frame {got[0].tolist()})", flush=True)

    # the noisy band: cells at the text-cell threshold, where only the
    # reference scan's exact gray gives its text_cells (frame 191 has one)
    with np.load(os.path.join(SMOKE_FIXTURE, "noisy_band.npz")) as z:
        jax_stats = torch.from_numpy(z["stats"]).cuda()
    noisy = torch.from_numpy(noisy_band()).cuda()
    got = torch.cat([k2.frame_stats_cuda(noisy[i : i + 32]) for i in range(0, len(noisy), 32)])
    want = torch.cat([k2.frame_stats_plain(noisy[i : i + 32]) for i in range(0, len(noisy), 32)])
    again = torch.cat([k2.frame_stats_cuda(noisy[i : i + 32]) for i in range(0, len(noisy), 32)])
    if not (torch.equal(got[:, 1], want[:, 1]) and torch.equal(got[:, 1], jax_stats[:, 1])):
        raise AssertionError("K2 noisy band: text_cells differ from the plain version or JAX")
    if not torch.equal(got, again):
        raise AssertionError("K2 noisy band: two runs differ")
    if got[190, 1].item() <= 0:
        raise AssertionError("K2 noisy band: frame 191 lost its text cell")
    k2_err = max(k2_err, check_close("K2 noisy band", got, want, 1e-5, 1e-6),
                 check_close("K2 noisy band vs JAX", got, jax_stats, 1e-5, 1e-6))
    print(f"K2 noisy band {list(noisy.shape)} in batches of 32: text_cells equal to the "
          f"plain version's and the JAX package's on all {len(noisy)} frames (frame 191: "
          f"{got[190, 1].item()}), the other stats within rtol 1e-5, deterministic",
          flush=True)
    # the gray itself, bit for bit: a one-pixel frame's mean luminance is
    # its gray / 1024 exactly in both versions (2^16 colours)
    idx = torch.arange(0, 1 << 24, 256, dtype=torch.int64)
    rgb = torch.stack([idx >> 16, (idx >> 8) & 255, idx & 255], -1).to(torch.uint8)
    px = rgb.reshape(-1, 1, 1, 3).cuda()
    got = k2.frame_stats_cuda(px)
    if not (torch.equal(got, k2.frame_stats_plain(px))
            and torch.equal(got[:, 3], k2.rgb_to_gray(rgb).cuda() / 1024.0)):
        raise AssertionError("K2: the gray of one-pixel frames differs from the plain version")
    print(f"K2 one-pixel frames of {len(rgb)} colours: stats bit-equal to the plain "
          "version's, gray bit-exact", flush=True)
    p = k2.ScanParams()
    for key, fr in (("K2", band), ("K2_ch_area", band_ch),
                    *((f"K2_w{w}", b) for w, (_, b) in sorted(script_bands.items()))):
        T, H, W, _ = fr.shape
        Hp, Wp = k2.padded_hw(H, W)
        geo = k2.launch_geometry(T, H, W)
        partials, out = k2.alloc_outputs(T, geo, fr.device)
        print(f"K2 {list(fr.shape)}: grid {geo.n_parts} x {geo.n_runs} blocks of "
              f"{geo.threads} threads, run {geo.run} frames", flush=True)
        rows[key] = timing_row(
            f"K2 {list(fr.shape)}",
            lambda fr=fr, geo=geo, partials=partials, out=out: k2.launch(fr, geo, p, partials, out),
            lambda fr=fr: k2.scan_stats_u8(fr), lambda fr=fr: k2.frame_stats_plain(fr),
            T * H * W * 3 + T * 16, 20.0 * T * Hp * Wp,
        )
        rows[key]["shape"] = [T, H, W, 3]
    rows["K2"]["max_abs_err"] = k2_err
    return rows


def drive(label, clip, area, reference, engine, card, spy=None, runs=("cold", "warm"),
          matches=str.__eq__):
    """Runs (cold, warm) of ``SubtitleExtractor(clip, area).run()`` with the
    default config for the engine's language, the launch counts set to 0
    just before each and read just after; every SRT must equal
    ``reference`` (``matches(got, reference)``). Returns the last run's
    (launches, extractor)."""
    import torch

    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.kernels import ctc_decode as k1
    from vse_tpu_torch.kernels import keyframe as k2
    from vse_tpu_torch.pipeline.extractor import SubtitleExtractor

    cfg = VseConfig(language=engine.language)
    for run in runs:
        ex = SubtitleExtractor(clip, area, cfg, engine=engine, device="cuda")
        if spy is not None:
            spy(ex)
        torch.cuda.reset_peak_memory_stats()
        k1.launches = 0
        k2.launches = 0
        srt_path = ex.run()
        launches = {"K1": k1.launches, "K2": k2.launches}
        with open(srt_path, encoding="utf-8") as f:
            got = f.read()
        secs = {k: round(v, 4) for k, v in ex.pass_seconds.items()}
        print(f"{label} ({run}) on {card}: pass seconds {secs}, {ex.n_spans} spans, "
              f"{ex.n_samples} OCR samples, launches {launches}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
        if not matches(got, reference):
            raise AssertionError(
                f"{label}: SRT differs from the reference:\n--- got\n{got}\n--- want\n{reference}")
    print(f"{label}: SRT {'equals' if got == reference else 'matches'} the JAX reference "
          f"({reference.count('-->')} cues, timings and text)", flush=True)
    return launches, ex


def graph_pools_mib() -> float:
    """MiB reserved in CUDA-graph private memory pools (every segment not
    in the default pool)."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 2**20


def main_path(card: str):
    """The keyframe strategy (an area) and the fps strategy (no area), each
    through the entry point with the default config, for en and for ch."""
    import torch

    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
    from vse_tpu_torch.video.synth import (
        CJK_FAMILIES, SCRIPT_FAMILIES, SMOKE_FIXTURE, compose_clip, load_fixture, recipe_area,
    )

    def reference(name):
        with open(os.path.join(SMOKE_FIXTURE, name), encoding="utf-8") as f:
            return f.read()

    def keyframe_path(label, key, name, engine):
        t0 = time.perf_counter()
        bands, recipe = load_fixture(recipe=f"recipe{name}.json")
        clip = compose_clip(bands, recipe, os.path.join(tmp, f"smoke{name}.avi"))
        kf, _ = drive(label, clip, recipe_area(recipe),
                      reference(f"reference{name or '_keyframe'}.srt"), engine, card)
        n_batches = -(-len(clip.frames) // 32)
        if kf["K2"] != n_batches:
            raise AssertionError(f"{label}: K2 launched {kf['K2']} times, want {n_batches}")
        if kf["K1"] < 1:
            raise AssertionError(f"{label}: K1 was never launched")
        phase(label, t0)
        by_path[key] = kf

    def no_area_path(label, key, name, engine):
        t0 = time.perf_counter()
        bands, recipe = load_fixture(recipe=f"recipe_{name}.json")
        clip = compose_clip(bands, recipe, os.path.join(tmp, f"smoke_{name}.avi"))
        by_path[key] = fps_path(label, clip, reference(f"reference_{name}.srt"),
                                json.loads(reference(f"reference_{name}_raw.json")),
                                engine, card)
        phase(label, t0)

    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        engine = OcrEngine(language="en", config=VseConfig(language="en"), device="cuda")
        print(f"en engine load: {time.perf_counter() - t0:.2f} s", flush=True)
        keyframe_path("main path, keyframe strategy", "keyframe", "", engine)
        no_area_path("fps path", "fps", "fps", engine)
        no_area_path("fps path, short cues", "fps_short", "fps_short", engine)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        pools_before = graph_pools_mib()
        t0 = time.perf_counter()
        engine = OcrEngine(language="ch", device="cuda")
        print(f"ch engine load: {time.perf_counter() - t0:.2f} s, {engine.charset.vocab_size + 1} "
              "classes", flush=True)
        keyframe_path("ch, keyframe strategy", "ch_keyframe", "_ch", engine)
        no_area_path("ch, fps path, short cues", "ch_fps_short", "ch_fps_short", engine)
        rec = engine.rec_forward.graphs
        print(f"ch rec graphs: {len(rec)} captured, input shapes "
              f"{sorted(k[0] for k in rec)}; CUDA-graph pools hold {graph_pools_mib():.1f} "
              f"MiB ({pools_before:.1f} MiB before the ch engine)", flush=True)
        del engine, rec
        gc.collect()
        torch.cuda.empty_cache()
        frames = script_paths(card, tmp, by_path, SCRIPT_FAMILIES, "phase 7")
        frames = script_paths(card, tmp, by_path, CJK_FAMILIES, "phase 8", frames)
        del frames
        many_paths(card, tmp, by_path)
    launches = {k: sum(p[k] for p in by_path.values()) for k in ("K1", "K2")}
    return launches, by_path


def script_paths(card, tmp, by_path, families, name, frames=None):
    """Phases 7 and 8: the keyframe strategy for each of ``families``, each
    with its own engine, freed (with its CUDA-graph pools) before the next.
    Every keyframe sample's OCR lines must equal the JAX extractor's
    records, and the SRT the JAX CLI's, but for ``FAULT_11``; every family
    runs before a failure is raised. A 21k-class head's logits must take
    K1's two-launch path, and the graph pools are printed after it.
    ``frames``: a 1.4 GB frame buffer to reuse for every clip; returns it."""
    import torch

    from vse_tpu_torch.kernels import ctc_decode as k1
    from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
    from vse_tpu_torch.video.synth import (
        compose_clip, load_script_fixture, load_script_reference, recipe_area,
    )

    failures = []
    for family in families:
        t0 = time.perf_counter()
        bands, recipe = load_script_fixture(family)
        ref = load_script_reference(family)
        engine = OcrEngine(language=ref["language"], device="cuda")
        load_s = time.perf_counter() - t0
        clip = compose_clip(bands, recipe, os.path.join(tmp, f"{family}.avi"), out=frames)
        frames = clip.frames
        seen_runs = []

        def spy(ex):  # every keyframe sample's lines, as refine_keyframe_spans gets them
            refine, seen = ex.refine_keyframe_spans, []
            seen_runs.append(seen)

            def keep_lines(spans, samples):
                seen.extend([s[1], [q[0][0], q[1][0], q[0][1], q[2][1]], t, p]
                            for s in samples for q, (t, p) in zip(s[2], s[3]))
                return refine(spans, samples)
            ex.refine_keyframe_spans = keep_lines

        label = f"{family} ({ref['language']}, C = {engine.charset.vocab_size + 1}), keyframe"
        runs = ("cold", "warm") if family in SCRIPT_WARM else ("cold",)
        f11 = FAULT_11.get(family, {})

        def matches(got, want):  # the reference, or it with the fault-11 cues
            cues = want.split("\n\n")
            for i, text in f11.get("cues", {}).items():
                cues[i - 1] = "\n".join(cues[i - 1].split("\n")[:2] + [text])
            return got in (want, "\n\n".join(cues))

        try:
            kf, ex = drive(label, clip, recipe_area(recipe), ref["srt"], engine, card, spy, runs,
                           matches)
        except AssertionError as e:  # an SRT that differs: go on to the next family
            failures.append(str(e))
            del engine
            gc.collect()
            torch.cuda.empty_cache()
            continue
        want, atol = ref["lines"], f11.get("score_atol", SCORE_ATOL)
        worst = 0.0
        for run, seen in zip(runs, seen_runs):
            bad = [(r, q) for r, q in zip(seen, want)
                   if r[0] != q[0] or r[2] not in (q[2], f11.get("texts", {}).get(q[2]))
                   or max(abs(a - b) for a, b in zip(r[1], q[1])) > 2
                   or (r[1] == q[1] and abs(r[3] - q[3]) > atol)]
            if len(seen) != len(want) or bad:
                failures.append(f"{label} ({run}): {len(seen)} OCR lines against the JAX "
                                f"package's {len(want)}; (port, JAX) pairs that differ:\n{bad}")
            worst = max([worst] + [abs(r[3] - q[3]) for r, q in zip(seen, want) if r[1] == q[1]])
        n_batches = -(-len(clip.frames) // 32)
        n_chunks = -(-ex.n_samples // ex.config.frame_batch)
        if kf["K2"] != n_batches or kf["K1"] != n_chunks:
            failures.append(f"{label}: launches {kf}, want K2 {n_batches}, K1 {n_chunks}")
        moved = sum(r[1] != q[1] for r, q in zip(seen, want))
        print(f"{label}: engine load {load_s:.2f} s; {len(seen)} OCR lines, {moved} boxes moved "
              f"(by at most 2 px), score max difference {worst!r} where the box is equal; "
              f"texts {sorted({r[2] for r in seen})}", flush=True)
        C = engine.charset.vocab_size + 1
        if C > 20000:
            if k1.decode_plan(80, C)[0]:
                failures.append(f"{label}: K1 took its fused path at C = {C}")
            aligned = "aligned" if C % 4 == 0 else "not aligned"
            print(f"{label}: K1's two-launch path at [64, 80, {C}] (rows {aligned} to 16 "
                  f"bytes); CUDA-graph pools hold {graph_pools_mib():.1f} MiB", flush=True)
        by_path[family] = kf
        del engine, ex
        gc.collect()
        torch.cuda.empty_cache()
        phase(label, t0)
    if failures:
        raise AssertionError(f"{name}:\n" + "\n".join(failures))
    return frames


def many_paths(card, tmp, by_path):
    """Phase 9: ``extract_many`` on two clips a strategy, then a queue of two
    tasks through ``ExtractionService`` (thread isolation), all on the en
    head with the default config."""
    import torch

    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.kernels import ctc_decode as k1
    from vse_tpu_torch.kernels import keyframe as k2
    from vse_tpu_torch.pipeline.multistream import extract_many
    from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
    from vse_tpu_torch.pipeline.service import ExtractionService, TaskStatus
    from vse_tpu_torch.video.synth import (
        SMOKE_FIXTURE, compose_clip, load_fixture, recipe_area,
    )

    with open(os.path.join(SMOKE_FIXTURE, "reference_many.json"), encoding="utf-8") as f:
        refs = json.load(f)
    cfg = VseConfig(language="en")
    engine = OcrEngine(language="en", config=cfg, device="cuda")
    bufs = [None, None]

    def clips(names):
        out = []
        for i, name in enumerate(names):
            bands, recipe = load_fixture(recipe=name)
            clip = compose_clip(bands, recipe, os.path.join(tmp, f"many{i}.avi"), out=bufs[i])
            bufs[i] = clip.frames
            out.append((name, clip, recipe))
        return out

    def counted(key, fn):
        k1.launches = k2.launches = 0
        out = fn()
        by_path[key] = {"K1": k1.launches, "K2": k2.launches}
        return out

    failures = []
    keyframe_area = recipe_area(load_fixture(recipe="recipe.json")[1])
    for key, names, area in (
            ("many_keyframe", ("recipe.json", "recipe_fps_short.json"), keyframe_area),
            ("many_fps", ("recipe_fps.json", "recipe_fps_short.json"), None)):
        t0 = time.perf_counter()
        batch = clips(names)
        stats = {}
        outs = [os.path.join(tmp, f"{key}_{i}.srt") for i in range(len(batch))]
        counted(key, lambda: extract_many([c for _, c, _ in batch], [area] * len(batch), cfg,
                                          engine=engine, output_paths=outs, device="cuda",
                                          stats=stats))
        launches = by_path[key]
        for (name, _, _), path in zip(batch, outs):
            with open(path, encoding="utf-8") as f:
                got = f.read()
            want = refs["keyframe" if area else "fps"][name]
            if got != want:
                failures.append(f"{key} {name}: SRT differs from the JAX extract_many's:\n"
                                f"--- got\n{got}\n--- want\n{want}")
        samples = sum(stats["samples"])
        want_chunks = math.ceil(samples / cfg.frame_batch)
        want_k2 = sum(math.ceil(len(c.frames) / 32) for _, c, _ in batch) if area else 0
        print(f"{key} on {card}: {len(batch)} videos, samples {stats['samples']}, "
              f"{stats['chunks']} pooled OCR chunks (ceil({samples} / {cfg.frame_batch}) = "
              f"{want_chunks}), launches {launches}; SRTs equal the JAX extract_many's: "
              f"{not failures}", flush=True)
        if stats["chunks"] != want_chunks or launches["K1"] != want_chunks \
                or launches["K2"] != want_k2:
            failures.append(f"{key}: launches {launches} for {stats['chunks']} chunks, want K1 "
                            f"{want_chunks}, K2 {want_k2}")
        phase(f"extract_many, {key[5:]} strategy", t0)

    t0 = time.perf_counter()
    (_, kf_clip, kf_recipe), (_, short_clip, _) = clips(("recipe.json", "recipe_fps_short.json"))
    svc = ExtractionService(config=cfg, device="cuda")
    tasks = [svc.add_task(kf_clip, recipe_area(kf_recipe), os.path.join(tmp, "svc0.srt")),
             svc.add_task(short_clip, None, os.path.join(tmp, "svc1.srt"))]
    counted("service", lambda: svc.run_all(block=True))
    for task, ref in zip(tasks, ("reference_keyframe.srt", "reference_fps_short.srt")):
        if task.status != TaskStatus.COMPLETED:
            failures.append(f"service task {ref}: {task.status}: {task.error}")
            continue
        with open(task.srt_path, encoding="utf-8") as f, \
                open(os.path.join(SMOKE_FIXTURE, ref), encoding="utf-8") as g:
            if f.read() != g.read():
                failures.append(f"service task: SRT differs from {ref}")
    launches = by_path["service"]
    print(f"service queue on {card}: {[t.status.value for t in tasks]}, launches {launches}",
          flush=True)
    if launches["K2"] != math.ceil(len(kf_clip.frames) / 32) or launches["K1"] < 2:
        failures.append(f"service: launches {launches}")
    phase("extraction service, thread isolation", t0)
    del engine, svc, bufs
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("phase 9:\n" + "\n".join(failures))


def fps_path(label, clip, reference, raw_ref, engine, card):
    """The fps strategy on a no-area clip. Every OCR line before the filters
    must equal the JAX package's (``raw_ref``): the same frame and text and
    a box within 2 px; the SRT must equal ``reference``; K1 must launch once
    per OCR chunk and K2 never. Returns the warm run's launches."""
    seen = {}

    def spy(ex):  # keep the OCR records as they reach the filters, and scores
        filt, gate = ex.apply_filters, ex._gate_lines
        seen["scores"] = []

        def keep_then_filter():
            seen["raw"] = list(ex.raw_records)
            filt()

        def keep_scores(*args):
            kept = gate(*args)
            seen["scores"].extend(prob for _, _, prob in kept)
            return kept
        ex.apply_filters, ex._gate_lines = keep_then_filter, keep_scores

    fps, ex = drive(label, clip, None, reference, engine, card, spy)
    raw = [[r.frame_no, list(r.coord), r.text, s] for r, s in zip(seen["raw"], seen["scores"])]
    bad = [(r, q) for r, q in zip(raw, raw_ref)
           if r[0] != q[0] or r[2] != q[2] or max(abs(a - b) for a, b in zip(r[1], q[1])) > 2
           or abs(r[3] - q[3]) > SCORE_ATOL]
    if len(raw) != len(raw_ref) or len(seen["scores"]) != len(seen["raw"]) or bad:
        raise AssertionError(
            f"{label}: {len(raw)} OCR lines before the filters against the JAX package's "
            f"{len(raw_ref)}; (port, JAX) pairs that differ in frame, text, a box by "
            f"more than 2 px or a score by more than {SCORE_ATOL}:\n{bad}")
    worst = max(abs(r[3] - q[3]) for r, q in zip(raw, raw_ref))
    print(f"{label}: all {len(raw)} OCR lines before the filters equal the JAX package's "
          f"(frame, text, box within 2 px, score within {SCORE_ATOL}: max difference "
          f"{worst!r}); texts {sorted({r[2] for r in raw})}", flush=True)
    # every batch of frame_batch frames (the last one padded) is OCRed in
    # chunks of max_batch_size
    fb, mb = ex.config.frame_batch, ex.engine.config.max_batch_size
    n_chunks = math.ceil(ex.n_samples / fb) * math.ceil(fb / mb)
    print(f"{label}: {len(ex.raw_records)} records kept by the filters; "
          f"{n_chunks} OCR chunks", flush=True)
    if fps["K2"] != 0:
        raise AssertionError(f"{label}: K2 launched {fps['K2']} times")
    if fps["K1"] != n_chunks:
        raise AssertionError(f"{label}: K1 launched {fps['K1']} times, want {n_chunks}")
    return fps


def sync_phase(card, by_path):
    """Phase 10: the sync re-timer's keyframe logs through K2's gray form,
    then two re-timings (numpy and device matcher), each output equal to
    the JAX package's. Returns the gray form's timing row."""
    import torch

    from vse_tpu_torch.kernels import keyframe as k2
    from vse_tpu_torch.sync import match, runner, synth, wav
    from vse_tpu_torch.sync.cli import create_arg_parser
    from vse_tpu_torch.sync.demux import make_keyframes
    from vse_tpu_torch.video.synth import SMOKE_FIXTURE

    t_phase = time.perf_counter()
    with open(os.path.join(SMOKE_FIXTURE, "reference_sync.json"), encoding="utf-8") as f:
        ref = json.load(f)
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        src, dst, sums = synth.write_wav_pair(tmp, ref["seed"])
        if sums != ref["wav_sha256"]:
            raise AssertionError(
                f"phase 10: the generator wrote other WAVs than the JAX references were made "
                f"from (sha256 {sums}, want {ref['wav_sha256']}): this machine's numpy draws "
                "another stream from the seed, so the references do not apply")
        script = os.path.join(tmp, "in.srt")
        cues = synth.script_cues(ref["seed"])
        synth.write_srt(script, cues)
        print(f"sync job: two WAVs of {os.path.getsize(src) / 1e6:.1f} / "
              f"{os.path.getsize(dst) / 1e6:.1f} MB (sha256 equal to the references'), "
              f"{len(cues)} cues, written in {time.perf_counter() - t0:.2f} s", flush=True)

        # the keyframe logs, every K2 launch kept for the parity check
        launched = []
        counted = k2.frame_stats_gray

        def keep(gray, p=k2.ScanParams()):
            out = counted(gray, p)
            launched.append((gray.clone(), out.clone()))
            return out

        logs, frames = {}, None
        k2.frame_stats_gray = keep
        try:
            for name in ("src", "dst"):
                clip = synth.scene_clip(ref["seed"], name, out=frames)
                frames = clip.frames
                logs[name] = os.path.join(tmp, f"{name}.keyframes.txt")
                k2.launches = 0
                t0 = time.perf_counter()
                make_keyframes(clip, logs[name], device="cuda")
                secs = time.perf_counter() - t0
                by_path[f"sync_keyframes_{name}"] = {"K1": 0, "K2": k2.launches}
                with open(logs[name], encoding="utf-8") as f:
                    got = f.read()
                kfs = [i - 3 for i, line in enumerate(got.splitlines()) if line == "i"]
                print(f"sync keyframes, {name} clip {list(clip.frames.shape)} on {card}: "
                      f"{secs:.3f} s, K2 launches {k2.launches}, keyframes {kfs}; log equal to "
                      f"the JAX make_keyframes log: {got == ref['keyframes'][name]}", flush=True)
                if got != ref["keyframes"][name]:
                    failures.append(f"sync keyframes {name}: the log differs from the JAX "
                                    f"package's:\n--- got\n{got}\n--- want\n{ref['keyframes'][name]}")
                n_batches = -(-len(clip.frames) // 32)
                if k2.launches != n_batches:
                    failures.append(f"sync keyframes {name}: K2 launched {k2.launches} times, "
                                    f"want {n_batches}")
        finally:
            k2.frame_stats_gray = counted
        del frames, clip
        gc.collect()

        # each launch against the plain version, and launched again
        err = 0.0
        for gray, got in launched:
            want = k2.frame_stats_gray_plain(gray)
            if not torch.equal(got[:, 1], want[:, 1]):
                failures.append(f"K2 gray {list(gray.shape)}: text_cells differ")
            if not torch.equal(got, k2.frame_stats_gray_cuda(gray)):
                failures.append(f"K2 gray {list(gray.shape)}: two runs differ")
            err = max(err, check_close(f"K2 gray {list(gray.shape)}", got, want, 1e-5, 1e-6))
        shapes = sorted({tuple(g.shape) for g, _ in launched})
        print(f"K2 gray form: {len(launched)} launches of shapes {shapes}, each within rtol "
              f"1e-5 of the plain version (max abs err {err!r}), text_cells exact, "
              "deterministic", flush=True)
        sample = launched[1][0]  # a [33, 184, 384] batch of the source clip
        del launched

        # the re-timings, the WAV loads and the matcher calls timed
        loads = []

        class TimedWavStream(wav.WavStream):
            def __init__(self, *args, **kwargs):
                t0 = time.perf_counter()
                super().__init__(*args, **kwargs)
                loads.append(time.perf_counter() - t0)

        calls = {}  # {matcher: [calls, host-clock seconds]}

        def timed(name, matcher):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = matcher(*args, **kwargs)
                calls[name][0] += 1
                calls[name][1] += time.perf_counter() - t0
                return out
            return call

        out = os.path.join(tmp, "out.srt")
        argv = [{"SRC": src, "DST": dst, "SCRIPT": script, "OUT": out, "KF_SRC": logs["src"],
                 "KF_DST": logs["dst"]}.get(a, a) for a in ref["argv"]] + ["--device", "cuda"]
        runner.WavStream = TimedWavStream
        wav.match_template_numpy = timed("numpy", match.match_template_numpy)
        wav.match_template_device = timed("device", match.match_template_device)
        try:
            for key, flag, path in (("srt", "0", "sync_numpy"), ("srt_device", "1", "sync_device")):
                os.environ["VSE_SYNC_DEVICE"] = flag
                loads.clear()
                calls.update(numpy=[0, 0.0], device=[0, 0.0])
                k2.launches = 0
                t0 = time.perf_counter()
                runner.run(create_arg_parser().parse_args(argv))
                secs = time.perf_counter() - t0
                by_path[path] = {"K1": 0, "K2": k2.launches}
                with open(out, encoding="utf-8") as f:
                    got = f.read()
                used, other = ("device", "numpy") if flag == "1" else ("numpy", "device")
                n_calls, spent = calls[used]
                matcher = "device (torch.fft on the card)" if flag == "1" else "numpy"
                print(f"sync re-time, {matcher} matcher, on {card}: {secs:.3f} s wall; WAV loads "
                      f"{[round(x, 3) for x in loads]} s; {n_calls} matcher calls, {spent:.3f} s, "
                      f"{spent / max(n_calls, 1) * 1e3:.3f} ms a call; {got.count('-->')} cues; SRT "
                      f"equal to the JAX runner's: {got == ref[key]}", flush=True)
                if got != ref[key]:
                    want = ref[key].split("\n\n")
                    diff = [(a, b) for a, b in zip(got.split("\n\n"), want) if a != b][:5]
                    failures.append(f"sync re-time ({matcher}): the SRT differs from the JAX "
                                    f"runner's; first cues that differ (port, JAX): {diff}")
                if n_calls == 0 or calls[other][0]:
                    failures.append(f"sync re-time: matcher calls {calls}, want only {used}")
        finally:
            runner.WavStream = wav.WavStream
            wav.match_template_numpy = match.match_template_numpy
            wav.match_template_device = match.match_template_device
            os.environ.pop("VSE_SYNC_DEVICE", None)
    if failures:
        raise AssertionError("phase 10:\n" + "\n".join(failures))

    # the gray form at the sync path's shape
    T, H, W = sample.shape
    geo = k2.launch_geometry(T, H, W)
    partials, res = k2.alloc_outputs(T, geo, sample.device)
    print(f"K2 gray {[T, H, W]}: grid {geo.n_parts} x {geo.n_runs} blocks of {geo.threads} "
          f"threads, run {geo.run} frames", flush=True)
    row = timing_row(
        f"K2 gray {[T, H, W]}",
        lambda: k2.launch(sample, geo, k2.ScanParams(), partials, res),
        lambda: k2.frame_stats_gray(sample), lambda: k2.frame_stats_gray_plain(sample),
        T * H * W * 4 + T * 16, 20.0 * T * H * W,
    )
    row.update(shape=[T, H, W], max_abs_err=err)
    del sample, partials, res
    torch.cuda.empty_cache()
    phase("sync re-timer", t_phase)
    return row


def main() -> int:
    t_all = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "vse_tpu_torch")):
        print("chip_smoke.py: the vse_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, cv2 {'present' if importlib.util.find_spec('cv2') else 'absent'}, "
          f"ninja {'present' if shutil.which('ninja') else 'absent'}", flush=True)
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    phase("environment", t0)

    from vse_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    print(f"built {os.path.relpath(info.path, here)} in {info.seconds:.2f} s", flush=True)
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip().split("ptxas info    : ")[-1], flush=True)
    phase("build", t0)

    t0 = time.perf_counter()
    rows = kernel_parity()
    phase("kernel parity", t0)

    launches, by_path = main_path(card)
    rows["K2_sync_gray"] = sync_phase(card, by_path)
    rows["K2"]["max_abs_err"] = max(rows["K2"]["max_abs_err"], rows["K2_sync_gray"]["max_abs_err"])
    launches = {k: sum(p[k] for p in by_path.values()) for k in ("K1", "K2")}
    from vse_tpu_torch.video.synth import CJK_FAMILIES, SCRIPT_FAMILIES, load_script_fixture

    meta = {
        "K1": ("ctc_greedy_decode", "vse_tpu_torch/csrc/ctc_decode.cu",
               "vse_tpu/kernels/ctc_decode.py:26"),
        "K2": ("keyframe_stats", "vse_tpu_torch/csrc/keyframe.cu",
               "vse_tpu/kernels/keyframe.py:117"),
    }
    # the paths whose launches run at each timed row's shape: en's C = 69
    # and 1280-wide band (phases 4-5 and 9), ch's and chinese_cht's C =
    # 21,060, japan's 21,249, ch's 400-wide band
    en_paths = ("keyframe", "fps", "fps_short", "many_keyframe", "many_fps", "service")
    ch_paths = ("ch_keyframe", "ch_fps_short")
    row_paths = {"K1": en_paths, "K1_c293": ("latin",),
                 "K1_c21060": ch_paths + ("chinese_cht",), "K1_c21249": ("japan",),
                 "K2": ("keyframe", "many_keyframe", "service"), "K2_ch_area": ch_paths,
                 "K2_sync_gray": ("sync_keyframes_src", "sync_keyframes_dst")}
    areas = {f: load_script_fixture(f)[1]["area"] for f in SCRIPT_FAMILIES + CJK_FAMILIES}
    for key in rows:
        if key.startswith("K2_w"):  # the families whose area is this wide
            row_paths[key] = tuple(f for f, a in areas.items() if a[3] - a[2] == int(key[4:]))
    kernels = []
    for key, (name, src, replaces) in meta.items():
        for row_key, paths in row_paths.items():
            if row_key.startswith(key):
                rows[row_key].update(
                    row_paths=list(paths),
                    row_launches=sum(by_path[p][key] for p in paths))
        r = rows[key]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[key],
            "launches_by_path": {p: n[key] for p, n in by_path.items()},
            "max_abs_err": r["max_abs_err"],
            "ms": r["device_us"] / 1e3, "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_us": r["device_us"],
            "wall_us": r["wall_us"], "loop_us": r["loop_us"],
            "share_of_bound": r["share_of_bound"], "shape": r["shape"],
            "row_paths": r["row_paths"], "row_launches": r["row_launches"],
        }
        if key == "K1":
            entry["half"] = r["half"]
            entry["at_c293"] = rows["K1_c293"]
            entry["at_c21060"] = rows["K1_c21060"]
            entry["at_c21249"] = rows["K1_c21249"]
        else:
            entry["at_ch_area"] = rows["K2_ch_area"]
            entry["at_scripts"] = {k: v for k, v in rows.items() if k.startswith("K2_w")}
            entry["at_sync_gray"] = rows["K2_sync_gray"]
        kernels.append(entry)
    print(f"[phase] total: {time.perf_counter() - t_all:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
