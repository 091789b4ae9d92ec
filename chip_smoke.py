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

11. modes accurate and auto on the server det (ResNet-50, FPN 256, the
   exported ``det_server`` weights) and the en rec head, against the JAX
   package's engine given the same weights (``reference_accurate.json``,
   ``tools/make_torch_smoke_fixture.py --accurate``; ROADMAP fault 15):
   ``extract --area --mode accurate`` on the keyframe clip (per-frame
   detection over all 500 frames: K1 once a chunk, K2 never), ``--mode
   auto`` on the same clip (the K2 scan, then the server det on the
   samples), and ``--mode accurate`` with no area on the short-cue clip
   (the server det on the 576 x 960 canvas, then the filters), each run
   cold and then warm, each SRT equal to the JAX SRT and every OCR line
   (every frame's for the first, every sample's for the second, every line
   before the filters for the third) equal in frame and text, its box
   within 2 px and, where the box is equal, its score within
   ``SCORE_ATOL``, but for ``FAULT_11``; then ``OcrEngine(decode="beam")``
   on 8 band frames (ids and texts equal, boxes within 2 px, scores within
   ``FAULT_11["beam"]``). It prints the pass seconds, the server det's
   device ms per batch at [8, 128, 960], at the band's [8, 160, 960] and at
   [8, 576, 960] (20 graph replays between CUDA events, TF32 off), and the
   K1 and K2 launches of each path (``row_launches``).

12. training (``vse_tpu_torch/train/``), after the inference phases:
   ``train_rec``'s step (``pretrain.rec_step``) and optimizer for
   ``steps=300, lr=1e-3`` from ``train_rec``'s own init
   (``assets/smoke/train_rec_init.npz``) for 20 steps on the fixed batches
   of ``reference_train.json``, each loss within 1% of the JAX step's and
   the 4 probe crops' K1 reads equal to its (empty on both sides); then 5
   steps from the committed en head, whose probe reads (real text) must
   equal the JAX steps' (``tools/make_torch_smoke_fixture.py --train``);
   K1 against its plain version at the probe's [4, 80, 69]; the warm
   step's ms at batch 64 and ``F.ctc_loss``'s forward + backward at [64,
   80, 69] (a yardstick). Then, with ``$VSE_MODELS``, ``$VSE_OPT_DIR`` and
   ``$VSE_DATA_DIR`` in a temporary directory holding the committed
   datasets under ``pretrain``'s cache names: ``pretrain rec --steps 300
   --batch 64 --pregen 4`` through ``pretrain.main`` (the device loop from
   a fresh init; the mean of the last 10 of its 300 losses below that of
   the first 10; K1 in the probe decodes, path ``train_rec``); the ms a
   step and the device-busy share of 20 warm steps of the same loop (host
   clock, then under the profiler); a fine-tune of a copy of the committed
   en head, ``pretrain rec --steps <its step + 300> --fresh-opt --lr 1e-4``
   (path ``train_rec_finetune``), whose head ``OcrEngine(device="cuda")``
   must read the en smoke bands as it reads them with the committed head
   (path ``train_rec_engine``); ``pretrain det --steps 200 --batch 16
   --pregen 16`` (the loss falls, measured likewise) and the ms a step and
   busy share of 10 warm det steps. The losses are those the device loops
   return; nothing may be written into ``checkpoints_torch/``.

13. the last modules (``eval.py``, ``utils/``, ``parallel/``,
   ``train/steps.py``): (a) the en keyframe clip through
   ``OcrEngine(mesh=make_mesh())`` at the card count and through a
   two-replica mesh on ``cuda:0`` (paths ``mesh_keyframe`` and
   ``mesh_keyframe_2x``), each SRT equal to ``reference_keyframe.srt``
   and K1's launches printed per replica; then the clip's 45 OCR samples
   as one batch of 45 (padded to 46 on two replicas): ids, masks, boxes,
   scores and valid flags equal to the single-device engine's; (b)
   ``multihost.initialize`` at world size 1 on NCCL (a localhost
   rendezvous) and 5 joint det + rec steps (``train/steps.py``) at full
   width (det 16 x 256 x 448 from ``train_det_en.npz``, rec 64 x 48 x 320
   from ``train_rec_en.npz``) from the JAX ``init_state``
   (``train_joint_init.npz``), each loss within 1% of the JAX step's
   (``reference_joint.json``, ``tools/make_torch_smoke_fixture.py
   --joint``), with TF32 on before the step is made (the step must turn
   it off); the ms a step (10 warm steps after those 5) and the
   device-busy share; the process group
   destroyed (the step runs neither kernel, so it is no path of
   ``launches_by_path``); (c) every SRT of phases 4-12 scored with the
   port's ``evaluate_srt`` against its JAX reference (line F1 and CER;
   F1 1.0 and CER 0 where the SRT is byte-equal); (d) one warm en keyframe
   pass (path ``traced_keyframe``) under ``trace_context`` with an
   ``annotate`` span: the Chrome trace must hold the span and as many host
   launch records of K1 and K2 (each in a span around its launching
   function) as the launch counters count, and their device records must
   name the kernels (the profiler drops a few device records in a
   long-lived process; the count of those it kept is printed).

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

import contextlib
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
# (label, SRT written, its JAX reference) of every path; phase 13 scores them
WRITTEN_SRTS = []
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
    # en's beam decode: ids, texts and boxes equal, the beam score (exp of
    # the mean log-prob of the best path) moved by the rec's sums: 0.0017
    # on the CPU (tests/_torch_helpers.py)
    "beam": {"score_atol": 0.003},
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
          matches=str.__eq__, config=None):
    """Runs (cold, warm) of ``SubtitleExtractor(clip, area).run()`` with the
    default config for the engine's language (or ``config``), the launch
    counts set to 0 just before each and read just after; every SRT must
    equal ``reference`` (``matches(got, reference)``). Returns the last
    run's (launches, extractor)."""
    import torch

    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.kernels import ctc_decode as k1
    from vse_tpu_torch.kernels import keyframe as k2
    from vse_tpu_torch.pipeline.extractor import SubtitleExtractor

    cfg = config or VseConfig(language=engine.language)
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
    WRITTEN_SRTS.append((label, got, reference))
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
            WRITTEN_SRTS.append((f"{key} {name}", got, want))
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
            got, want = f.read(), g.read()
        WRITTEN_SRTS.append((f"service {ref}", got, want))
        if got != want:
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


def accurate_phase(card, by_path):
    """Phase 11: modes accurate and auto on the server det, each path's SRT
    and OCR lines against the JAX references, the beam decode, and the
    server det's device time per batch."""
    import torch

    from vse_tpu_torch.core.config import Mode, VseConfig
    from vse_tpu_torch.pipeline import extractor as port_extractor
    from vse_tpu_torch.pipeline import ocr_engine
    from vse_tpu_torch.video.synth import (
        SMOKE_FIXTURE, compose_clip, compose_frames, load_fixture, recipe_area,
    )

    t_phase = time.perf_counter()
    with open(os.path.join(SMOKE_FIXTURE, "reference_accurate.json"), encoding="utf-8") as f:
        refs = json.load(f)
    failures = []

    def box_of(q):
        return [int(q[0][0]), int(q[1][0]), int(q[0][1]), int(q[2][1])]

    def check_lines(label, got, want, atol=SCORE_ATOL):
        bad = [(g, w) for g, w in zip(got, want)
               if g[0] != w[0] or g[2] != w[2] or max(abs(a - b) for a, b in zip(g[1], w[1])) > 2
               or (g[1] == w[1] and abs(g[3] - w[3]) > atol)]
        worst = max((abs(g[3] - w[3]) for g, w in zip(got, want) if g[1] == w[1]), default=0.0)
        if bad or len(got) != len(want):
            failures.append(f"{label}: {len(got)} lines against the JAX package's {len(want)}; "
                            f"pairs that differ: {bad[:10]}")
        print(f"{label}: {len(got)} OCR lines against the JAX package's {len(want)}, "
              f"{len(bad)} differ (frame, text, box within 2 px, score within {atol}; "
              f"max score difference on equal boxes {worst!r})", flush=True)

    seen = []
    feed = port_extractor.DetSpanTracker.feed
    refine = port_extractor.SubtitleExtractor.refine_keyframe_spans
    gate = port_extractor.SubtitleExtractor._gate_and_record

    def keep_feed(self, frame_no, dt_box, rec_res):
        seen.extend([frame_no, box_of(q), t, p] for q, (t, p) in zip(dt_box, rec_res))
        return feed(self, frame_no, dt_box, rec_res)

    def keep_samples(self, spans, samples):
        seen.extend([s[1], box_of(q), t, p] for s in samples for q, (t, p) in zip(s[2], s[3]))
        return refine(self, spans, samples)

    def keep_gated(self, frame_no, dt_box, rec_res, *a, **kw):
        seen.extend([frame_no, list(b), t, p] for b, t, p in self._gate_lines(dt_box, rec_res))
        return gate(self, frame_no, dt_box, rec_res, *a, **kw)

    hooks = {"feed": (port_extractor.DetSpanTracker, "feed", keep_feed),
             "refine": (port_extractor.SubtitleExtractor, "refine_keyframe_spans", keep_samples),
             "gate": (port_extractor.SubtitleExtractor, "_gate_and_record", keep_gated)}

    def run_path(key, label, recipe_name, mode, engine, hook, with_area):
        t0 = time.perf_counter()
        bands, recipe = load_fixture(recipe=recipe_name)
        with tempfile.TemporaryDirectory() as tmp:
            clip = compose_clip(bands, recipe, os.path.join(tmp, f"{key}.avi"))
            ref = refs[key]
            cls, name, fn = hooks[hook]

            def spy(ex):
                seen.clear()
                setattr(cls, name, fn)

            try:
                launches, ex = drive(label, clip, recipe_area(recipe) if with_area else None,
                                     ref["srt"], engine, card, spy=spy,
                                     config=VseConfig(language="en", mode=mode))
            finally:
                setattr(cls, name, {"feed": feed, "refine": refine, "gate": gate}[hook])
        check_lines(label, list(seen), ref["lines"])
        n = ex.n_samples
        fb, mb = ex.config.frame_batch, engine.config.max_batch_size
        chunks = math.ceil(n / fb) * math.ceil(fb / mb)
        want_k2 = math.ceil(recipe["n_frames"] / 32) if mode == Mode.AUTO else 0
        print(f"{label}: {n} frames OCRed in {chunks} chunks; launches {launches}", flush=True)
        if launches != {"K1": chunks, "K2": want_k2} or chunks < 1:
            failures.append(f"{label}: launches {launches}, want K1 = {chunks} and "
                            f"K2 = {want_k2}")
        by_path[key] = launches
        phase(label, t0)

    cfg_acc = VseConfig(language="en", mode=Mode.ACCURATE)
    t0 = time.perf_counter()
    engine = ocr_engine.OcrEngine("en", Mode.ACCURATE, cfg_acc, device="cuda")
    print(f"accurate engine load: {time.perf_counter() - t0:.2f} s, det {engine.spec.det_variant}, "
          f"rec {engine.rec_variant}", flush=True)
    if engine.spec.det_variant != "server":
        raise AssertionError("phase 11: mode accurate did not resolve the server det")
    run_path("keyframe_accurate", "accurate mode, per-frame detection", "recipe.json",
             Mode.ACCURATE, engine, "feed", True)
    run_path("fps_short_accurate", "accurate mode, no area (fps strategy)",
             "recipe_fps_short.json", Mode.ACCURATE, engine, "gate", False)

    # the server det's device time per batch, from graph replays
    det_ms = {}
    with torch.inference_mode():
        for shape in ((8, 128, 960, 3), (8, 160, 960, 3), (8, 576, 960, 3)):
            x = torch.randn(shape, device="cuda")
            engine.det_forward(x)
            graph = engine.det_forward.graphs[(shape, x.dtype, x.device)][0]
            graph.replay()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                graph.replay()
            end.record()
            end.synchronize()
            det_ms[str(list(shape))] = start.elapsed_time(end) / 20
    print(f"server det on {card}, device ms per batch (CUDA-graph replays, TF32 "
          f"{'on' if torch.backends.cudnn.allow_tf32 else 'off'}): {json.dumps(det_ms)}", flush=True)
    print(f"CUDA-graph pools after the accurate engine: {graph_pools_mib():.1f} MiB", flush=True)
    del engine, graph
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    engine = ocr_engine.OcrEngine("en", Mode.AUTO, VseConfig(language="en", mode=Mode.AUTO),
                                  device="cuda")
    if engine.spec.det_variant != "server":
        raise AssertionError("phase 11: mode auto on the card did not resolve the server det")
    run_path("keyframe_auto", "auto mode, keyframe strategy", "recipe.json", Mode.AUTO, engine,
             "refine", True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # the beam decode on band frames, with the beam's ids
    t0 = time.perf_counter()
    ref = refs["beam"]
    bands, recipe = load_fixture()
    frames = compose_frames(bands, recipe, n_frames=max(ref["frames"]) + 1)
    y0, y1 = ref["band"]
    ids = []
    beam_fn = ocr_engine.ctc_prefix_beam_decode

    def keep_ids(*a, **kw):
        out = beam_fn(*a, **kw)
        ids.append([int(i) for i in out[0]])
        return out

    beam = ocr_engine.OcrEngine("en", Mode.ACCURATE, cfg_acc, device="cuda", decode="beam")
    ocr_engine.ctc_prefix_beam_decode = keep_ids
    try:
        res = beam.predict_batch(frames[ref["frames"], y0:y1].copy(), origin=(y0, 0))
        ids.clear()
        t1 = time.perf_counter()
        res = beam.predict_batch(frames[ref["frames"], y0:y1].copy(), origin=(y0, 0))
        beam_s = time.perf_counter() - t1
    finally:
        ocr_engine.ctc_prefix_beam_decode = beam_fn
    flat = lambda recs: [[i, *line] for i, r in enumerate(recs) for line in r]  # noqa: E731
    got = [[[box_of(q), t, p] for q, (t, p) in zip(d, r)] for d, r in res]
    if ids != ref["ids"]:
        failures.append(f"beam: ids {ids} against the JAX beam's {ref['ids']}")
    check_lines("beam decode, 8 band frames", flat(got), flat(ref["records"]),
                FAULT_11["beam"]["score_atol"])
    print(f"beam decode: ids {'equal' if ids == ref['ids'] else 'differ'}; warm pass "
          f"{beam_s:.4f} s on {card}", flush=True)
    del beam
    gc.collect()
    torch.cuda.empty_cache()
    phase("beam decode", t0)
    if failures:
        raise AssertionError("phase 11:\n" + "\n".join(failures))
    phase("accurate and auto modes", t_phase)
    return det_ms


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
                WRITTEN_SRTS.append((path, got, ref[key]))
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


@contextlib.contextmanager
def loss_history(name):
    """The loss of every step that ``device_loop.<name>`` runs while inside
    (what the loop returns; ``train_rec`` / ``train_det`` drop it)."""
    from vse_tpu_torch.train import device_loop

    real, seen = getattr(device_loop, name), []

    def spy(**kw):
        history = real(**kw)
        seen.extend(history)
        return history

    setattr(device_loop, name, spy)
    try:
        yield seen
    finally:
        setattr(device_loop, name, real)


def falls(history, n=10):
    """(mean of the first ``n`` losses, mean of the last ``n``)."""
    return statistics.fmean(history[:n]), statistics.fmean(history[-n:])


def busy_share(fn):
    """(wall s, device-busy share) of ``fn()`` under torch.profiler (device
    activity only): the union of the device ops' intervals over the wall
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return wall / 1e6, busy / wall


def train_phase(card, by_path):
    """Phase 12: training on the card. Returns its numbers."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vse_tpu_torch.kernels import ctc_decode as k1
    from vse_tpu_torch.kernels import keyframe as k2
    from vse_tpu_torch.models.crnn import CRNNRecognizer
    from vse_tpu_torch.models.db_detector import DBDetector
    from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
    from vse_tpu_torch.train import optim
    from vse_tpu_torch.train import pretrain as P
    from vse_tpu_torch.train.device_loop import run_det_device_loop, run_rec_device_loop
    from vse_tpu_torch.video.synth import SMOKE_FIXTURE, load_fixture
    from vse_tpu_torch.weights import TORCH_CKPT_DIR, from_jax_params, load_flat

    t_phase = time.perf_counter()
    failures, out = [], {}
    with open(os.path.join(SMOKE_FIXTURE, "reference_train.json"), encoding="utf-8") as f:
        ref = json.load(f)["rec"]
    rec_npz = os.path.join(SMOKE_FIXTURE, "train_rec_en.npz")
    with np.load(rec_npz) as z:
        images, texts = z["images"], [str(t) for t in z["texts"]]
    charset = P._rec_train_charset("en", False, True)
    labels, lengths = P.encode_labels(charset, texts, P.rec_train_config(charset).max_label_len)
    dev = torch.device("cuda")
    x_all = torch.from_numpy((images.astype(np.float32) / 255.0 - 0.5) / 0.5).to(dev)
    lab, ln = torch.from_numpy(labels).to(dev), torch.from_numpy(lengths).to(dev)
    head_npz = os.path.join(TORCH_CKPT_DIR, "rec_en_mobile.npz")
    committed = sorted(os.listdir(TORCH_CKPT_DIR))

    def steps_from(npz, n):
        """``n`` of train_rec's steps (optimizer for steps=300, lr=1e-3)
        from the variables in ``npz`` on the fixture's batches."""
        model = CRNNRecognizer(charset.vocab_size).to(dev)
        model.load_state_dict(from_jax_params(load_flat(npz)))
        opt = optim.Optimizer(P.rec_optimizer(ref["lr"], 100, ref["steps"]), P.trainable(model))
        losses = [float(P.rec_step(model, opt, x_all[i], lab[i], ln[i]))
                  for i in torch.tensor(ref["indices"][:n], device=dev)]
        return model, opt, losses

    # 1. step parity: train_rec's step and optimizer, 20 steps from
    # train_rec's init (the losses; the probe reads nothing yet on either
    # side), then 5 from the committed en head (the probe's reads, real
    # text; its losses of ~1e-4 are printed only)
    t0 = time.perf_counter()
    model, opt, losses = steps_from(os.path.join(SMOKE_FIXTURE, "train_rec_init.npz"), 20)
    gaps = [abs(a - b) / b for a, b in zip(losses, ref["losses"])]
    for k, (a, b, gap) in enumerate(zip(losses, ref["losses"], gaps)):
        print(f"rec step {k}: loss {a:.6f} (JAX {b:.6f}), gap {gap:.2e}", flush=True)
    out["step_parity_max_gap"] = max(gaps)
    if max(gaps) > 0.01:
        failures.append(f"rec step parity: a loss {max(gaps):.2%} from the JAX step's (limit 1%)")
    probe = P.predict_texts(model, x_all[:4], charset)
    if probe != ref["probe_texts"]:
        failures.append(f"after 20 steps the probe reads {probe}, JAX {ref['probe_texts']}")
    head, _, head_losses = steps_from(head_npz, len(ref["head_losses"]))
    probe = P.predict_texts(head, x_all[:4], charset)
    out["head_loss_gaps"] = [abs(a - b) / b for a, b in zip(head_losses, ref["head_losses"])]
    print(f"from the en head, {len(head_losses)} steps: losses {head_losses} (JAX "
          f"{ref['head_losses']}); probe reads {probe} (JAX {ref['head_probe_texts']})",
          flush=True)
    if probe != ref["head_probe_texts"] or not all(probe):
        failures.append(f"probe reads {probe} against the JAX step's {ref['head_probe_texts']}")
    # K1 against its plain version at the probe's shape, [4, 80, 69]
    head.eval()
    with torch.no_grad():
        logits = head(x_all[:4]).contiguous()
    ids, mask, scores = k1.greedy_decode_cuda(logits)
    p_ids, p_mask, p_scores = k1.collapse(*k1.argmax_lse_plain(logits))
    if not (torch.equal(ids, p_ids) and torch.equal(mask, p_mask)):
        failures.append("K1 at the probe's shape: ids or mask differ from the plain version")
    out["k1_probe_max_abs_err"] = check_close("K1 probe scores", scores, p_scores, 1e-5, 1e-6)
    del head
    # the warm step alone, fixed batches, synchronized
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for idx in ref["indices"]:
        P.rec_step(model, opt, x_all[torch.tensor(idx, device=dev)], lab[idx], ln[idx])
    torch.cuda.synchronize()
    out["rec_step_ms"] = (time.perf_counter() - t1) * 1e3 / len(ref["indices"])
    # F.ctc_loss forward and backward at [64, 80, 69], a yardstick
    lg = torch.randn(64, 80, charset.vocab_size + 1, device=dev, requires_grad=True)
    lb, lln = lab[:64], ln[:64]

    def ctc_fwd_bwd():
        F.ctc_loss(F.log_softmax(lg, -1).transpose(0, 1), lb,
                   torch.full((64,), 80, device=dev, dtype=torch.long), lln,
                   reduction="none").mean().backward()

    out["ctc_loss_fwd_bwd_ms"] = loop_us(ctc_fwd_bwd, n=50) / 1e3
    print(f"rec step at batch 64: {out['rec_step_ms']:.3f} ms warm; F.ctc_loss forward + "
          f"backward at [64, 80, 69]: {out['ctc_loss_fwd_bwd_ms']:.3f} ms", flush=True)
    phase("training: step parity", t0)

    def timed_loop(loop, n):
        """(ms a step, device-busy share) of ``n`` warm steps of ``loop``:
        once on the host clock, once under the profiler."""
        loop(n)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loop(n)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3 / n
        return ms, busy_share(lambda: loop(n))[1]

    names = ("VSE_MODELS", "VSE_OPT_DIR", "VSE_DATA_DIR")
    saved_env = {k: os.environ.get(k) for k in names}
    with tempfile.TemporaryDirectory() as tmp:
        for k in names:
            os.environ[k] = os.path.join(tmp, k.lower())
            os.makedirs(os.environ[k])
        try:
            shutil.copy(rec_npz, P.rec_dataset_path("en", 4, 64))
            shutil.copy(os.path.join(SMOKE_FIXTURE, "train_det_en.npz"), P.det_dataset_path(16))
            # 2. the rec device loop at full width, through main, from scratch
            t0 = time.perf_counter()
            k1.launches = k2.launches = 0
            with loss_history("run_rec_device_loop") as history:
                P.main(["rec", "--language", "en", "--steps", "300", "--batch", "64",
                        "--pregen", "4"])
            by_path["train_rec"] = {"K1": k1.launches, "K2": k2.launches}
            out["rec_loss_first_last_10"] = falls(history)
            first, last = out["rec_loss_first_last_10"]
            if not (len(history) == 300 and last < first):
                failures.append(f"train_rec: the loss did not fall ({first} -> {last})")
            if by_path["train_rec"]["K1"] < 1:
                failures.append("train_rec: K1 was never launched by the probe decode")
            phase("training: rec, 300 steps at batch 64", t0)
            model = CRNNRecognizer(charset.vocab_size).to(dev)
            opt = optim.Optimizer(P.rec_optimizer(1e-3, 100, 300), P.trainable(model))
            out["rec_ms_per_step"], out["rec_busy"] = timed_loop(
                lambda n: run_rec_device_loop(
                    raw_imgs=images, labels=labels, lengths=lengths,
                    step_core=lambda x, a, b: P.rec_step(model, opt, x, a, b),
                    steps=n, start_step=0, batch=64, seed=0, device=dev, chunk=n), 20)
            # 3. a fine-tune of the committed en head through main, and the
            # engine reading the bands with it as with the committed head
            t0 = time.perf_counter()
            os.environ["VSE_MODELS"] = os.path.join(tmp, "finetune")
            os.makedirs(os.environ["VSE_MODELS"])
            for ext in (".npz", ".vse_meta.json"):
                shutil.copy(os.path.join(TORCH_CKPT_DIR, "rec_en_mobile" + ext),
                            os.environ["VSE_MODELS"])
            start = int(P.load_meta(os.path.join(TORCH_CKPT_DIR, "rec_en_mobile"))["step"])
            k1.launches = k2.launches = 0
            with loss_history("run_rec_device_loop") as history:
                P.main(["rec", "--language", "en", "--steps", str(start + 300), "--batch",
                        "64", "--pregen", "4", "--fresh-opt", "--lr", "1e-4"])
            by_path["train_rec_finetune"] = {"K1": k1.launches, "K2": k2.launches}
            out["finetune_loss_first_last_10"] = falls(history)
            phase("training: fine-tune of the en head, 300 steps", t0)
            t0 = time.perf_counter()
            bands, _ = load_fixture()
            frames = np.stack([bands[k] for k in sorted(bands)])
            engine = OcrEngine(language="en", device="cuda")
            k1.launches = k2.launches = 0
            res = engine.predict_batch(frames)
            torch.cuda.synchronize()
            by_path["train_rec_engine"] = {"K1": k1.launches, "K2": k2.launches}
            reads = [[t for t, _ in r[1]] for r in res]
            del engine
            os.environ["VSE_MODELS"] = TORCH_CKPT_DIR
            engine = OcrEngine(language="en", device="cuda")
            want = [[t for t, _ in r[1]] for r in engine.predict_batch(frames)]
            del engine
            # the det below writes its head under the temporary directory
            os.environ["VSE_MODELS"] = os.path.join(tmp, "vse_models")
            print(f"the fine-tuned head reads the en smoke bands as {reads}, the committed "
                  f"head as {want}; launches {by_path['train_rec_engine']}", flush=True)
            if reads != want or not any(any(r) for r in reads):
                failures.append(f"the fine-tuned head reads {reads}, the committed head {want}")
            if by_path["train_rec_engine"]["K1"] < 1:
                failures.append("the engine on the trained head never launched K1")
            phase("training: the trained head in the engine", t0)
            # 4. the det device loop
            t0 = time.perf_counter()
            with loss_history("run_det_device_loop") as history:
                P.main(["det", "--steps", "200", "--batch", "16", "--pregen", "16"])
            out["det_loss_first_last_10"] = falls(history)
            first, last = out["det_loss_first_last_10"]
            if not (len(history) == 200 and last < first):
                failures.append(f"train_det: the loss did not fall ({first} -> {last})")
            phase("training: det, 200 steps at batch 16", t0)
            with np.load(P.det_dataset_path(16)) as z:
                ds = {k: z[k] for k in z.files}
            model = P.flax_init(DBDetector("mobile", train_outputs=True), 0).to(dev)
            opt = optim.Optimizer(P.det_optimizer(5e-4, 200), P.trainable(model))
            out["det_ms_per_step"], out["det_busy"] = timed_loop(
                lambda n: run_det_device_loop(
                    ds=ds, step_core=lambda b: P.det_step(model, opt, b), steps=n,
                    start_step=0, batch=16, seed=0, device=dev, chunk=n), 10)
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    print(f"training on {card}: rec {out['rec_ms_per_step']:.2f} ms a step warm (batch 64), "
          f"busy {out['rec_busy']:.1%}; det {out['det_ms_per_step']:.2f} ms a step (batch 16), "
          f"busy {out['det_busy']:.1%}; losses (first 10 -> last 10): rec "
          f"{out['rec_loss_first_last_10']}, fine-tune {out['finetune_loss_first_last_10']}, "
          f"det {out['det_loss_first_last_10']}", flush=True)
    if sorted(os.listdir(TORCH_CKPT_DIR)) != committed:
        failures.append("training wrote into checkpoints_torch/")
    if failures:
        raise AssertionError("phase 12:\n" + "\n".join(failures))
    phase("training", t_phase)
    return out


def joint_batch(vocab_charset):
    """The full-width joint batch of ``tools/make_torch_smoke_fixture.py
    --joint``: the 16 det frames normalized as the det device loop
    normalizes them, the first 64 rec crops with their labels."""
    import numpy as np

    from vse_tpu_torch.train import pretrain as P
    from vse_tpu_torch.video.synth import SMOKE_FIXTURE

    with np.load(os.path.join(SMOKE_FIXTURE, "train_det_en.npz")) as z:
        det = {k: z[k] for k in z.files}
    with np.load(os.path.join(SMOKE_FIXTURE, "train_rec_en.npz")) as z:
        images, texts = z["images"][:64], [str(t) for t in z["texts"][:64]]
    mean, std = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])
    batch = {"det_images": ((det.pop("images").astype(np.float32) / 255.0 - mean) / std)
             .astype(np.float32)}
    batch.update({k: v.astype(np.float32) for k, v in det.items()})
    batch["labels"], batch["label_lengths"] = P.encode_labels(
        vocab_charset, texts, P.rec_train_config(vocab_charset).max_label_len)
    batch["rec_images"] = ((images.astype(np.float32) / 255.0) - 0.5) / 0.5
    return batch


def last_modules_phase(card, by_path):
    """Phase 13: the meshed engine, the joint step over torch.distributed,
    the SRT scores, and a traced pass. Returns its numbers."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.eval import evaluate_srt
    from vse_tpu_torch.kernels import ctc_decode as k1
    from vse_tpu_torch.kernels import keyframe as k2
    from vse_tpu_torch.parallel import multihost
    from vse_tpu_torch.parallel.sharding import make_mesh
    from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
    from vse_tpu_torch.post.srt import SrtFile
    from vse_tpu_torch.train import pretrain as P
    from vse_tpu_torch.train import steps as S
    from vse_tpu_torch.utils.tracing import annotate, trace_context
    from vse_tpu_torch.video.synth import SMOKE_FIXTURE, compose_clip, load_fixture, recipe_area

    t_phase = time.perf_counter()
    failures, out = [], {}
    with open(os.path.join(SMOKE_FIXTURE, "reference_keyframe.srt"), encoding="utf-8") as f:
        reference = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        bands, recipe = load_fixture()
        clip = compose_clip(bands, recipe, os.path.join(tmp, "smoke.avi"))
        area = recipe_area(recipe)

        # (a) the meshed engine: the card count, then two replicas on cuda:0
        t0 = time.perf_counter()
        cfg = VseConfig(language="en")
        engines, samples = {}, None
        for key, mesh in (("mesh_keyframe", make_mesh()),
                          ("mesh_keyframe_2x", make_mesh(2, devices=["cuda:0", "cuda:0"]))):
            engine = OcrEngine(language="en", config=cfg, device="cuda", mesh=mesh)
            seen = []

            def spy(ex, seen=seen):  # every OCR sample, as the keyframe strategy batches them
                predict = ex.engine.predict_batch

                def keep(frames, *a, **kw):
                    seen.append(torch.as_tensor(frames).cpu())
                    return predict(frames, *a, **kw)
                ex.engine.predict_batch = keep

            for r in engine.replicas:
                r.k1_launches = 0
            launches, ex = drive(f"phase 13, {key} ({mesh.shape['data']} replicas)", clip, area,
                                 reference, engine, card, spy=spy, runs=("cold",))
            del engine.predict_batch
            per = [r.k1_launches for r in engine.replicas]
            print(f"{key}: K1 launches per replica {per} (of {launches['K1']}), K2 "
                  f"{launches['K2']}; {ex.n_samples} OCR samples", flush=True)
            if sum(per) != launches["K1"] or min(per) < 1:
                failures.append(f"{key}: K1 launches per replica {per}, counted {launches['K1']}")
            by_path[key] = launches
            engines[key] = engine
            batch = torch.cat(seen)
            if batch.shape[0] != ex.n_samples:
                failures.append(f"{key}: {batch.shape[0]} frames OCRed for {ex.n_samples} samples")
            samples = batch if samples is None else samples
            out[key] = {"replicas": len(per), "k1_per_replica": per}
        single = OcrEngine(language="en", config=cfg, device="cuda")
        frames = samples.to("cuda")
        want = single.ocr_arrays(frames)
        names = ("boxes", "det_scores", "valid", "ids", "mask", "rec_scores")
        for key, engine in engines.items():
            for r in engine.replicas:
                r.k1_launches = 0
            got = engine.ocr_arrays(frames)
            differ = [n for n, a, b in zip(names, got, want) if not np.array_equal(a, b)]
            per = [r.k1_launches for r in engine.replicas]
            print(f"{key}: the {frames.shape[0]} samples {list(frames.shape)} as one batch "
                  f"(K1 per replica {per}): {', '.join(names)} equal to the single-device "
                  f"engine's: {not differ}", flush=True)
            if differ:
                failures.append(f"{key}: {differ} differ from the single-device engine's at "
                                f"B {frames.shape[0]}")
        phase("meshed engine", t0)

        # (b) torch.distributed at world size 1 (NCCL), the joint step at full width
        t0 = time.perf_counter()
        with open(os.path.join(SMOKE_FIXTURE, "reference_joint.json"), encoding="utf-8") as f:
            ref = json.load(f)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        multihost.initialize(f"127.0.0.1:{port}", 1, 0)
        backend = dist.get_backend()
        with np.load(os.path.join(SMOKE_FIXTURE, "train_joint_init.npz")) as z:
            flat = {k: z[k] for k in z.files}
        charset = P._rec_train_charset("en", False, True)
        # cuDNN's default in a fresh process (phases 4-12 turned it off):
        # the step must turn TF32 off itself
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        det, rec = S.make_models(ref["vocab"])
        state, tx = S.load_state(det, rec,
                                 {k[4:]: v for k, v in flat.items() if k.startswith("det/")},
                                 {k[4:]: v for k, v in flat.items() if k.startswith("rec/")},
                                 lr=ref["lr"])
        mesh = make_mesh()
        step = S.make_train_step(det, rec, tx, mesh)
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            failures.append("joint step: TF32 left on")
        state = S.shard_state(mesh, state)
        local = S.place_batch(mesh, joint_batch(charset))
        losses = []
        for _ in range(ref["steps"]):
            state, metrics = step(state, local)
            losses.append(float(metrics["loss"]))
        # 10 warm steps after the 5 of the parity check
        secs = []
        for _ in range(10):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, _ = step(state, local)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
        jax_losses = ref["full"]["bf16"]["loss"]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, jax_losses)]
        f32_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["full"]["f32"]["loss"]))

        def one_step():
            nonlocal state
            state, _ = step(state, local)

        wall, busy = busy_share(one_step)
        dist.destroy_process_group()
        shapes = {k: list(v.shape) for k, v in local.items() if k in ("det_images", "rec_images")}
        print(f"joint det + rec step on {card}: torch.distributed {backend} at world size 1, "
              f"mesh {mesh.shape}, batches {shapes}; losses {losses} against the JAX step's "
              f"{jax_losses} (bf16 modules): largest relative difference {max(rel)!r} (against "
              f"the JAX step with f32 modules: {f32_rel!r}); {statistics.median(secs) * 1e3:.2f}"
              f" ms a warm step (host clock, median of 10), one more under the profiler {wall * 1e3:.2f} ms with "
              f"the device {busy:.1%} busy", flush=True)
        if max(rel) > 0.01 or not losses[-1] < losses[0]:
            failures.append(f"joint step: losses {losses} against the JAX step's {jax_losses}")
        out["joint_step"] = {"backend": backend, "losses": losses, "jax_losses": jax_losses,
                             "max_rel_diff": max(rel), "max_rel_diff_f32": f32_rel,
                             "ms": statistics.median(secs) * 1e3, "busy": busy}
        del det, rec, state, step, local
        gc.collect()
        torch.cuda.empty_cache()
        phase("joint step", t0)

        # (d) one warm en keyframe pass under the profiler, with a span. The
        # profiler can drop a kernel's device record ("Out-of-range" in its
        # log; 2-3 of K2's 16 in this script's process), so launches are
        # counted from the host-side launch records, each inside a span the
        # launching functions open for this pass; the device records give
        # the kernels' names
        t0 = time.perf_counter()
        span = "phase 13: en keyframe pass"
        launchers = {"K1": (k1, "greedy_decode_cuda", "ctc_decode_fused_kernel"),
                     "K2": (k2, "frame_stats_cuda", "keyframe_stats_kernel")}

        def spanned(key, fn):
            def call(*a, **kw):
                with torch.profiler.record_function(f"vse::{key}"):
                    return fn(*a, **kw)
            return call

        real = {key: getattr(mod, name) for key, (mod, name, _) in launchers.items()}
        for key, (mod, name, _) in launchers.items():
            setattr(mod, name, spanned(key, real[key]))
        try:
            with trace_context(os.path.join(tmp, "trace")) as path:
                with annotate(span):
                    launches, _ = drive("phase 13, traced keyframe pass", clip, area, reference,
                                        engines["mesh_keyframe"], card, runs=("warm",))
        finally:
            for key, (mod, name, _) in launchers.items():
                setattr(mod, name, real[key])
        by_path["traced_keyframe"] = launches
        with open(path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        kernels = {e["args"].get("correlation"): e["name"] for e in events
                   if e.get("cat") == "kernel"}
        runtime = [e for e in events if e.get("cat") == "cuda_runtime"
                   and "aunch" in e.get("name", "")]
        counts, records = {}, {}
        for key, (_, _, kernel) in launchers.items():
            inside = [r for s_ in events if s_.get("name") == f"vse::{key}"
                      and s_.get("ph") == "X" and s_.get("cat") == "user_annotation"
                      for r in runtime if r.get("tid") == s_.get("tid")
                      and s_["ts"] <= r["ts"] <= s_["ts"] + s_["dur"]]
            names = [kernels.get(r["args"].get("correlation")) for r in inside]
            counts[key] = len(inside)
            records[key] = sum(1 for n in names if n is not None and kernel in n)
            if any(n is not None and kernel not in n for n in names) or not records[key]:
                failures.append(f"trace: {key}'s launches recorded kernels {set(names)}")
        spans = sum(e.get("name") == span for e in events)
        print(f"traced keyframe pass: {os.path.getsize(path) / 2**20:.1f} MiB Chrome trace; "
              f"launches in the trace {counts} against the counters {launches}; their device "
              f"records {records} (K1 ctc_decode_fused_kernel, K2 keyframe_stats_kernel; the "
              f"rest dropped by the profiler); span '{span}' {spans} times", flush=True)
        if counts != launches or spans < 1:
            failures.append(f"trace: launches {counts}, counters {launches}, spans {spans}")
        out["trace"] = {"launches": counts, "counters": launches, "device_records": records,
                        "spans": spans}
        del engines, single
        gc.collect()
        torch.cuda.empty_cache()
        phase("traced pass", t0)

    # (c) every SRT written above, scored against its JAX reference
    scores = {}
    for label, got, want in WRITTEN_SRTS:
        r = evaluate_srt(SrtFile.loads(got), SrtFile.loads(want))
        scores[label] = {"f1": r.f1, "cer": r.cer, "byte_equal": got == want}
        print(f"  SRT score, {label}: line F1 {r.f1!r}, CER {r.cer!r} ({r.matched} of {r.n_ref} "
              f"cues matched, {r.n_pred} written){', byte-equal' if got == want else ''}",
              flush=True)
        if got == want and (r.f1 != 1.0 or r.cer != 0.0):
            failures.append(f"{label}: byte-equal SRT scores F1 {r.f1}, CER {r.cer}")
    out["srt_scores"] = scores
    if failures:
        raise AssertionError("phase 13:\n" + "\n".join(failures))
    phase("the last modules", t_phase)
    return out


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
    det_ms = accurate_phase(card, by_path)
    rows["K2_sync_gray"] = sync_phase(card, by_path)
    training = train_phase(card, by_path)
    last = last_modules_phase(card, by_path)
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
    en_paths = ("keyframe", "fps", "fps_short", "many_keyframe", "many_fps", "service",
                "keyframe_accurate", "fps_short_accurate", "keyframe_auto", "train_rec_engine",
                "mesh_keyframe", "mesh_keyframe_2x", "traced_keyframe")
    ch_paths = ("ch_keyframe", "ch_fps_short")
    row_paths = {"K1": en_paths, "K1_c293": ("latin",),
                 "K1_c21060": ch_paths + ("chinese_cht",), "K1_c21249": ("japan",),
                 "K2": ("keyframe", "many_keyframe", "service", "keyframe_auto",
                        "mesh_keyframe", "mesh_keyframe_2x", "traced_keyframe"),
                 "K2_ch_area": ch_paths,
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
    print(f"server det device ms per batch: {json.dumps(det_ms)}", flush=True)
    print(f"training: {json.dumps(training)}", flush=True)
    print(f"phase 13: {json.dumps(last)}", flush=True)
    print(f"[phase] total: {time.perf_counter() - t_all:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
