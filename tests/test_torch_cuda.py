"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. This file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: ids, masks and text_cells exact; scores
and float stats rtol 1e-5 / atol 1e-6. Both kernels sum in a fixed order,
so two runs on the same input are bit-equal. K2's gray is checked bit for
bit through one-pixel frames, whose mean luminance is gray / 1024 exactly.
"""

import os
import re

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vse_tpu_torch.kernels import ctc_decode as k1
from vse_tpu_torch.kernels import keyframe as k2
from vse_tpu_torch.pipeline.feed import device_prefetch
from vse_tpu_torch.video.decode import FrameBatch, FrameStream, InMemoryVideo
from vse_tpu_torch.video.synth import SMOKE_FIXTURE, noisy_band

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def logits_with_ties(n, t, c, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, t, c)) * 4.0).astype(np.float32)
    for row, shift in ((0, 7), (1, c - 3)):
        best = x[row].argmax(-1)
        x[row, np.arange(t), (best + shift) % c] = x[row].max(-1)
    x[2:4, :, 0] = x[2:4].max(-1) + 5.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("t", [1, 80])
# en, the ten non-CJK heads (C <= 128: 8 lanes a step; C <= 512: 16), a
# wide fused head, ch and japan (the two-launch path)
@pytest.mark.parametrize("c", [1, 69, 83, 98, 99, 111, 139, 147, 162, 201, 293, 298, 1000,
                               21060, 21249])
def test_k1_cuda_matches_plain(cuda, c, t):
    x = logits_with_ties(64, t, c, seed=c + t).to(cuda)
    before = k1.launches
    ids, mask, scores = k1.ctc_greedy_decode(x)
    assert k1.launches == before + 1
    ids_p, mask_p, scores_p = k1.collapse(*k1.argmax_lse_plain(x))
    assert torch.equal(ids, ids_p) and torch.equal(mask, mask_p)
    torch.testing.assert_close(scores, scores_p, rtol=1e-5, atol=1e-6)
    assert torch.all(scores[2:4] == 1.0)
    again = k1.greedy_decode_cuda(x)
    assert all(torch.equal(a, b) for a, b in zip((ids, mask, scores), again))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("c", [69, 21249])
def test_k1_cuda_half_logits_match_plain(cuda, c, dtype):
    x = logits_with_ties(64, 80, c, seed=c).to(cuda).to(dtype)
    ids, mask, scores = k1.ctc_greedy_decode(x)
    ids_p, mask_p, scores_p = k1.collapse(*k1.argmax_lse_plain(x))
    assert torch.equal(ids, ids_p) and torch.equal(mask, mask_p)
    torch.testing.assert_close(scores, scores_p, rtol=1e-5, atol=1e-6)
    assert torch.all(scores[2:4] == 1.0)
    again = k1.greedy_decode_cuda(x)
    assert all(torch.equal(a, b) for a, b in zip((ids, mask, scores), again))
    # an odd start: no row 16-byte aligned
    y = x.reshape(64 * 80, c)[1:801].reshape(10, 80, c)
    got = k1.greedy_decode_cuda(y)
    want = k1.collapse(*k1.argmax_lse_plain(y))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k1_cuda_unaligned_rows(cuda):
    """A view that starts one step in: no row is 16-byte aligned."""
    x = logits_with_ties(9, 5, 2051, seed=1).to(cuda).reshape(45, 2051)[1:41]
    x = x.reshape(8, 5, 2051)
    ids, mask, scores = k1.greedy_decode_cuda(x)
    ids_p, mask_p, scores_p = k1.collapse(*k1.argmax_lse_plain(x))
    assert torch.equal(ids, ids_p) and torch.equal(mask, mask_p)
    torch.testing.assert_close(scores, scores_p, rtol=1e-5, atol=1e-6)


def device_ops(fn):
    """(name, stream) of each device-side record the profiler returns for
    one call of ``fn``, with host syncs raising inside it."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return [(e.name, getattr(e, "device_resource_id", None)) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def assert_only_kernels(fn, n_kernels, marker, attempts=3):
    """``fn`` issues exactly ``n_kernels`` device operations, each a kernel
    whose name holds ``marker``, all on one stream.

    The profiler (CUPTI) now and then loses activity records: on the card,
    3 of 400 profiled K1 decodes in one process came back short, twice
    without the row kernel of the two-launch path and once with no record
    at all, while the decode ran. So a count that comes back short with
    nothing but the wanted kernels in it is taken again, up to
    ``attempts`` times; any other record, or one kernel too many, fails at
    once."""
    for _ in range(attempts):
        work = device_ops(fn)
        msg = (f"want {n_kernels} '{marker}' kernels on one stream; the profiler's "
               f"records: {work}")
        assert all(marker in n for n, _ in work) and len({s for _, s in work}) <= 1, msg
        assert len(work) <= n_kernels, msg
        if len(work) == n_kernels:
            return
    raise AssertionError(f"{msg} ({attempts} profiles, each short)")


@pytest.mark.parametrize("c,n_kernels", [(69, 1), (293, 1), (21060, 2), (21249, 2)])
def test_k1_decode_issues_only_its_kernels(cuda, c, n_kernels):
    """The profiler's device records during one decode: exactly K1's
    kernels (one for the fused path, two for large C), on one stream. C =
    293 is latin's head, on the 16-lane fused path."""
    x = logits_with_ties(8, 80, c, seed=3).to(cuda)
    assert_only_kernels(lambda: k1.ctc_greedy_decode(x), n_kernels, "ctc_")


def test_k2_issues_only_its_kernel(cuda):
    x = torch.zeros((32, 104, 1280, 3), dtype=torch.uint8, device=cuda)
    assert_only_kernels(lambda: k2.scan_stats_u8(x), 1, "keyframe_stats")


K2_SHAPES = [
    (32, 104, 1280),  # the main path's band
    (32, 104, 400),  # ch's band (its fixture's area is 400 wide)
    (20, 104, 400),  # ch's tail batch
    (32, 104, 272),  # arabic's and ka's bands (the families' areas are 272-528 wide)
    (32, 104, 304),  # korean's band
    (32, 104, 312),  # th's band
    (32, 104, 328),  # cyrillic's band
    (32, 104, 384),  # el's band
    (32, 104, 456),  # devanagari's band
    (32, 104, 472),  # te's band
    (32, 104, 488),  # latin's band
    (32, 104, 528),  # ta's band
    (20, 104, 272),  # a family's tail batch (500 frames = 15 x 32 + 20)
    (32, 37, 301),  # ragged
    (1, 8, 128),
    (5, 38, 300),  # W % 16 != 0 and H % 4 != 0
    (1, 104, 1280),  # T = 1
    (13, 104, 1280),  # T not a multiple of the run
    (3, 12, 160),  # W % 16 == 0 < Wp: 16-byte loads and a pad-column strip
]


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_cuda_matches_plain(cuda, shape):
    t, h, w = shape
    rng = np.random.default_rng(h * w)
    f = rng.integers(0, 40, (t, h, w, 3)).astype(np.uint8)
    f[t // 2 :, h // 4 : h // 4 + 6, 4 : w - 4 : 3] = 250
    x = torch.from_numpy(f).to(cuda)
    got = k2.frame_stats_cuda(x)
    want = k2.frame_stats_plain(x)
    assert torch.equal(got[:, 1], want[:, 1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert got[0, 2].item() == 0.0
    before = k2.launches
    again = k2.scan_stats_u8(x)
    assert k2.launches == before + 1
    assert torch.equal(got, again)


def test_k2_gray_is_bit_exact_on_the_card(cuda):
    """One-pixel frames: mean luminance is the pixel's gray / 1024 exactly
    on both sides, so K2's gray shows bit for bit (2^20 colours, the rest
    of the 2^24 by stride)."""
    for lo in range(0, 1 << 24, 1 << 20):  # 2^16 frames a launch
        idx = torch.arange(lo, lo + (1 << 20), 16, dtype=torch.int64)
        rgb = torch.stack([idx >> 16, (idx >> 8) & 255, idx & 255], -1).to(torch.uint8)
        x = rgb.reshape(-1, 1, 1, 3).to(cuda)
        got = k2.frame_stats_cuda(x)
        want = k2.rgb_to_gray(rgb).to(cuda) / 1024.0
        assert torch.equal(got[:, 3], want)
        assert torch.equal(got, k2.frame_stats_plain(x))
        assert torch.equal(got, k2.frame_stats_cuda(x))


@pytest.mark.parametrize("band", ["random", "noisy"])
def test_k2_fma_gray_matches_plain_and_jax_on_bands(cuda, band):
    if band == "noisy":
        f = noisy_band()
        with np.load(os.path.join(SMOKE_FIXTURE, "noisy_band.npz")) as z:
            jax_stats = torch.from_numpy(z["stats"]).to(cuda)
    else:
        f = np.random.default_rng(11).integers(0, 256, (96, 104, 1280, 3)).astype(np.uint8)
        jax_stats = None
    x = torch.from_numpy(f).to(cuda)
    got = torch.cat([k2.frame_stats_cuda(x[i : i + 32]) for i in range(0, len(x), 32)])
    want = torch.cat([k2.frame_stats_plain(x[i : i + 32]) for i in range(0, len(x), 32)])
    assert torch.equal(got[:, 1], want[:, 1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    again = torch.cat([k2.frame_stats_cuda(x[i : i + 32]) for i in range(0, len(x), 32)])
    assert torch.equal(got, again)
    if jax_stats is not None:
        assert torch.equal(got[:, 1], jax_stats[:, 1]) and got[190, 1].item() > 0
        torch.testing.assert_close(got, jax_stats, rtol=1e-5, atol=1e-6)


# K2's gray form: the sync path's padded batch, the decimated 720p frame
# unpadded, an odd width (the scalar path), T = 1, and an unaligned tensor
K2_GRAY_SHAPES = [(33, 184, 384), (32, 184, 384), (21, 184, 384), (33, 180, 320),
                  (5, 38, 301), (1, 184, 384), (1, 1, 1), (7, 20, 128)]


def gray_frames(shape, seed):
    """Scenes of random 4 x 4 blocks that change every few frames (edges,
    text-like cells and cuts) in f32 gray."""
    t, h, w = shape
    rng = np.random.default_rng(seed)
    blocks = rng.random((t, -(-h // 4), -(-w // 4))).astype(np.float32)
    blocks[1::3] = blocks[0::3][: len(blocks[1::3])]  # steady runs between cuts
    return np.repeat(np.repeat(blocks, 4, axis=1), 4, axis=2)[:, :h, :w].copy()


@pytest.mark.parametrize("shape", K2_GRAY_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
def test_k2_gray_cuda_matches_plain(cuda, shape, aligned):
    f = torch.from_numpy(gray_frames(shape, sum(shape)))
    if aligned:
        x = f.to(cuda)
    else:  # a contiguous tensor 4 bytes past a 16-byte boundary: scalar loads
        buf = torch.empty(f.numel() + 1, device=cuda)
        x = buf[1:].view(shape)
        x.copy_(f)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
    got = k2.frame_stats_gray_cuda(x)
    want = k2.frame_stats_gray_plain(x)
    assert torch.equal(got[:, 1], want[:, 1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert got[0, 2].item() == 0.0
    before = k2.launches
    again = k2.frame_stats_gray(x)
    assert k2.launches == before + 1
    assert torch.equal(got, again)
    on_cpu = k2.frame_stats_gray(f)  # a CPU tensor: the plain version, not counted
    assert k2.launches == before + 1
    torch.testing.assert_close(on_cpu, want.cpu(), rtol=1e-5, atol=1e-6)


def test_k2_gray_form_equals_the_u8_form_on_its_gray(cuda):
    """K2 on u8 RGB and K2 on the table gray of the same frames read the
    same stats bit for bit: the two loads feed one kernel body."""
    rng = np.random.default_rng(5)
    u8 = torch.from_numpy(rng.integers(0, 256, (33, 45, 80, 3)).astype(np.uint8)).to(cuda)
    assert torch.equal(k2.frame_stats_cuda(u8), k2.frame_stats_gray_cuda(k2.rgb_to_gray(u8)))


def test_k2_gray_issues_only_its_kernel(cuda):
    x = torch.zeros((33, 184, 384), device=cuda)
    assert_only_kernels(lambda: k2.frame_stats_gray(x), 1, "keyframe_stats")


def test_eager_gray_on_the_card_is_the_cpu_eager_gray(cuda):
    """The sync path's source-order gray on the card, on all 2^24 colours,
    bit-equal to the CPU's (which tests/test_torch_kernel_repairs.py holds
    bit-equal to the JAX package's eager ``rgb_to_gray``): a CUDA division
    by a Python scalar would be a reciprocal multiply (ROADMAP fault 10)."""
    idx = torch.arange(1 << 24, dtype=torch.int64)
    rgb = torch.stack([idx >> 16, (idx >> 8) & 255, idx & 255], -1).to(torch.uint8)
    want = k2.rgb_to_gray_eager(rgb)
    got = k2.rgb_to_gray_eager(rgb.to(cuda)).cpu()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def distinct_batches(n, shape):
    """Batches whose every byte depends on the batch and its position."""
    base = np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape)
    for i in range(n):
        yield FrameBatch(((base * 7 + i * 131) % 251).astype(np.uint8),
                         np.arange(shape[0]) + 1, np.ones(shape[0], bool))


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("hold", [True, False])
def test_device_prefetch_equals_a_synchronous_upload(cuda, depth, hold):
    """20 batches of distinct contents, cropped by the stream's reader to a
    band, through the pinned ring and the side stream. The consumer's
    stream is kept busy before each read, so the feeder runs ahead and the
    pinned buffers and freed device batches are reused under pressure: each
    read must still see its own batch."""
    shape = (32, 120, 1280, 3)
    frames = np.concatenate([b.frames for b in distinct_batches(20, shape)])
    hosts = [np.ascontiguousarray(frames[i : i + 32, 8:112]) for i in range(0, len(frames), 32)]
    stream = FrameStream(InMemoryVideo(frames, 25.0, "distinct.avi"), 32,
                         region=(8, 112, 0, 1280))
    got, kept = [], []
    for b, dev in device_prefetch(stream, cuda, depth=depth):
        assert dev.is_cuda and dev.shape == (32, 104, 1280, 3) and dev.is_contiguous()
        torch.cuda._sleep(20_000_000)  # ~10 ms of device time before the read
        got.append(dev.double().sum())
        if hold:
            kept.append(dev)
    torch.cuda.synchronize()
    assert [g.item() for g in got] == [float(h.sum(dtype=np.float64)) for h in hosts]
    for dev, host in zip(kept, hosts):
        assert torch.equal(dev, torch.from_numpy(host).to(cuda))


def test_device_prefetch_calls_share_one_side_stream(cuda):
    """Forty calls, as forty clips' scans make: the caching allocator keeps
    freed batches per stream, so with a stream a call the reserved memory
    would grow by a segment a call (up to the pool's 32 streams); with one
    side stream it holds after the first call."""
    shape = (32, 104, 720, 3)
    reserved = []
    for _ in range(40):
        for _, dev in device_prefetch(distinct_batches(3, shape), cuda):
            dev.sum()
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved(cuda))
    assert reserved[-1] == reserved[0]


@pytest.mark.parametrize("threads,run", [(32, 1), (64, 3), (128, 8), (256, 2)])
def test_k2_cuda_geometries_agree(cuda, threads, run):
    rng = np.random.default_rng(threads + run)
    x = torch.from_numpy(rng.integers(0, 256, (11, 20, 160, 3)).astype(np.uint8)).to(cuda)
    g = k2.launch_geometry(11, 20, 160, threads=threads, run=run)
    partials, got = k2.alloc_outputs(11, g, cuda)
    k2.launch(x, g, k2.ScanParams(), partials, got)
    want = k2.frame_stats_plain(x)
    assert torch.equal(got[:, 1], want[:, 1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        k1.greedy_decode_cuda(torch.zeros((2, 3, 4), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        k1.greedy_decode_cuda(torch.zeros((2, 4, 3), device=cuda).transpose(1, 2))
    with pytest.raises(TypeError):
        k2.frame_stats_cuda(torch.zeros((2, 8, 8, 3), device=cuda))
    with pytest.raises(TypeError):
        k2.frame_stats_gray_cuda(torch.zeros((2, 8, 8), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        k2.frame_stats_gray_cuda(torch.zeros((2, 8, 16), device=cuda)[:, :, ::2])
    with pytest.raises(ValueError):
        k2.frame_stats_gray_cuda(torch.zeros((2, 8, 8, 3), device=cuda))
    with pytest.raises(ValueError):
        k2.frame_stats_cuda(torch.zeros((2, 8, 16, 3), dtype=torch.uint8, device=cuda)[:, :, ::2])
    with pytest.raises(ValueError):
        k2.frame_stats_cuda(torch.zeros((2, 8, 16, 3), dtype=torch.uint8, device=cuda),
                            k2.ScanParams(segment_height=3))


def emulated_models(cuda, family="en", vocab_size=68):
    """The engine's det and rec models, switched to the reference's bf16
    numerics."""
    from vse_tpu_torch.models import bf16
    from vse_tpu_torch.models.crnn import CRNNRecognizer
    from vse_tpu_torch.models.ppocr_det import PPOCRv3DetMobile
    from vse_tpu_torch.weights import from_jax_params, load_det_npz, load_rec_flat

    det = PPOCRv3DetMobile()
    det.load_state_dict(load_det_npz())
    rec = CRNNRecognizer(vocab_size)
    rec.load_state_dict(from_jax_params(load_rec_flat(family)))
    return [bf16.emulate(m).to(cuda).eval() for m in (det, rec)]


@pytest.mark.parametrize("which", ["det", "rec", "rec_ch"])
def test_graphed_forward_equals_eager_on_the_card(cuda, which):
    """A graph replay runs the eager forward's kernels: bit-equal outputs,
    fresh inputs through one captured graph, one graph per shape. ``rec_ch``
    is the ch head (21,060 classes) at the ch main path's chunk of 64 crops
    and a tail chunk of 24: each graph keeps its own [N, 80, 21060] f32
    output."""
    from vse_tpu_torch.models.graphed import GraphedForward

    if which == "rec_ch":
        _, rec = emulated_models(cuda, "ch", 21059)
    else:
        det, rec = emulated_models(cuda)
    if which == "det":
        model, shapes = det, [(2, 96, 160, 3), (1, 64, 128, 3)]
    elif which == "rec":
        model, shapes = rec, [(16, 48, 320, 3), (3, 48, 320, 3)]
    else:
        model, shapes = rec, [(64, 48, 320, 3), (24, 48, 320, 3)]
    fwd = GraphedForward(model)
    rng = np.random.default_rng(0)
    with torch.inference_mode():
        for shape in shapes + shapes[:1]:  # a second shape, then the first again
            for _ in range(2):
                x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
                assert torch.equal(fwd(x), model(x))
    assert len(fwd.graphs) == 2


def tiny_clip(cue, n=60):
    """A 2.4 s in-memory clip, 1280 x 240, one en cue in its band."""
    from vse_tpu_torch.video.decode import InMemoryVideo
    from vse_tpu_torch.video.synth import compose_frames, load_fixture

    bands, _ = load_fixture()
    recipe = {"width": 1280, "height": 240, "fps": 25, "n_frames": n,
              "background": [30, 40, 60], "band_origin": [120, 0],
              "cues": [{"band": cue, "first": 5, "last": n - 5}]}
    return InMemoryVideo(compose_frames(bands, recipe), 25.0, f"{cue}.avi")


def test_pooled_chunk_k1_matches_plain_decode(cuda, tmp_path, monkeypatch):
    """``extract_many``'s keyframe pass pools two videos' samples into
    shared chunks: every chunk's logits go through one K1 launch, whose ids,
    masks and scores equal the plain decode of the same logits."""
    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.core.subtitle_area import SubtitleArea
    from vse_tpu_torch.pipeline import ocr_engine
    from vse_tpu_torch.pipeline.multistream import extract_many

    seen = []
    decode = ocr_engine.ctc_greedy_decode

    def keep(logits):
        out = decode(logits)
        seen.append((logits.clone(), [o.clone() for o in out]))
        return out
    monkeypatch.setattr(ocr_engine, "ctc_greedy_decode", keep)
    clips = [tiny_clip("band0"), tiny_clip("band2")]
    stats = {}
    before = k1.launches
    extract_many(clips, [SubtitleArea(120, 224, 0, 1280)] * 2, VseConfig(language="en"),
                 output_paths=[str(tmp_path / "a.srt"), str(tmp_path / "b.srt")],
                 device="cuda", stats=stats)
    assert len(seen) == stats["chunks"] == k1.launches - before
    assert stats["chunks"] == -(-sum(stats["samples"]) // 8) and min(stats["samples"]) > 0
    for logits, (ids, mask, scores) in seen:
        assert logits.is_cuda and logits.shape[0] == 64
        ids_p, mask_p, scores_p = k1.collapse(*k1.argmax_lse_plain(logits))
        assert torch.equal(ids, ids_p) and torch.equal(mask, mask_p)
        torch.testing.assert_close(scores, scores_p, rtol=1e-5, atol=1e-6)


def test_service_queue_on_the_card_equals_single_runs(cuda, tmp_path):
    """Two tiny tasks through ``ExtractionService`` (thread isolation) on
    the card: each SRT equals the one ``SubtitleExtractor.run()`` writes for
    that video with the service's engine."""
    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.core.subtitle_area import SubtitleArea
    from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
    from vse_tpu_torch.pipeline.service import ExtractionService, TaskStatus

    cfg = VseConfig(language="en")
    area = SubtitleArea(120, 224, 0, 1280)
    clips = [tiny_clip("band0"), tiny_clip("band1")]
    svc = ExtractionService(config=cfg, device="cuda")
    tasks = [svc.add_task(c, area, str(tmp_path / f"svc{i}.srt")) for i, c in enumerate(clips)]
    svc.run_all(block=True)
    assert all(t.status == TaskStatus.COMPLETED for t in tasks), [t.error for t in tasks]
    for i, (t, c) in enumerate(zip(tasks, clips)):
        ex = SubtitleExtractor(c, area, cfg, engine=svc._engine, device="cuda")
        ex.subtitle_output_path = str(tmp_path / f"one{i}.srt")
        ex.append_output = lambda *a: None
        with open(ex.run(), encoding="utf-8") as f, open(t.srt_path, encoding="utf-8") as g:
            want = f.read()
            assert g.read() == want and want.count("-->") == 1


def test_graphed_server_det_equals_its_eager_bf16_forward(cuda):
    """The server det (``DBDetector("server")`` on the exported weights,
    emulated) replayed as a CUDA graph equals its eager ``forward_bf16``
    bit for bit, at two canvases and back."""
    from vse_tpu_torch.models import bf16 as B16
    from vse_tpu_torch.models.db_detector import DBDetector
    from vse_tpu_torch.models.graphed import GraphedForward
    from vse_tpu_torch.weights import load_det_server

    model = DBDetector("server")
    model.load_state_dict(load_det_server())
    B16.emulate(model).to(cuda).eval()
    fwd = GraphedForward(model)
    rng = np.random.default_rng(1)
    with torch.inference_mode():
        for shape in [(8, 160, 960, 3), (2, 96, 320, 3), (8, 160, 960, 3)]:
            x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
            assert torch.equal(fwd(x), model(x))
    assert len(fwd.graphs) == 2


def test_per_frame_detection_launches_k1_once_a_chunk(cuda, tmp_path):
    """Mode accurate with an area on 16 frames of the smoke clip: every
    frame through the server det, and one K1 launch for each OCR chunk
    (two batches of ``frame_batch`` 8, each one chunk), K2 never."""
    from vse_tpu_torch.core.config import Mode, VseConfig
    from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
    from vse_tpu_torch.video.decode import InMemoryVideo
    from vse_tpu_torch.video.synth import compose_frames, load_fixture, recipe_area

    bands, recipe = load_fixture()
    frames = compose_frames(bands, recipe, n_frames=40)[24:40]
    clip = InMemoryVideo(np.ascontiguousarray(frames), 25.0, str(tmp_path / "acc.avi"))
    cfg = VseConfig(language="en", mode=Mode.ACCURATE)
    ex = SubtitleExtractor(clip, recipe_area(recipe), cfg, device="cuda")
    assert ex.engine.spec.det_variant == "server"
    k1.launches = k2.launches = 0
    ex.append_output = lambda *a: None
    ex.run()
    chunks = -(-16 // cfg.frame_batch) * -(-cfg.frame_batch // cfg.max_batch_size)
    assert (k1.launches, k2.launches) == (chunks, 0) and ex.n_samples == 16
    assert ex.raw_records and all(r.text for r in ex.raw_records)


# --- training (vse_tpu_torch/train): the card against the CPU ------------
# Tolerances: the optimizer's updates within 1e-6 (foreach kernels may
# contract a multiply-add on the card); loss values rtol 1e-4 and gradients
# within 1e-3 of the largest (cuDNN's and F.ctc_loss's sum orders, CTC's
# backward uses atomics); the augmentation within 0.02 on the 0-255 scale
# (its products sum in another order; the JAX package's own jit and eager
# runs differ by 0.0054).


def _seeded_tree(seed, device):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(device) for s in ((3, 4), (5,), (2, 3, 3))]


@pytest.mark.parametrize("chain", ["rec", "det"])
def test_train_optimizer_on_the_card_equals_cpu(cuda, chain):
    from vse_tpu_torch.train import optim
    from vse_tpu_torch.train.pretrain import det_optimizer, rec_optimizer

    outs = {}
    for dev in ("cpu", cuda):
        params = _seeded_tree(0, dev)
        tx = rec_optimizer(1e-2, 2, 8) if chain == "rec" else det_optimizer(1e-2, 101)
        opt = optim.Optimizer(tx, params)
        for k in range(6):
            grads = [g * (3.0 if k % 2 else 0.1) for g in _seeded_tree(k + 1, dev)]
            opt.step(grads)
        outs[str(dev)] = ([p.cpu() for p in params], optim.state_to_flat(opt.state))
    (p_cpu, s_cpu), (p_gpu, s_gpu) = outs.values()
    for a, b in zip(p_cpu, p_gpu):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6)
    assert s_cpu.keys() == s_gpu.keys()
    for k in s_cpu:
        np.testing.assert_allclose(s_gpu[k], s_cpu[k], rtol=1e-6, atol=1e-7)


def test_train_losses_on_the_card_equal_cpu(cuda):
    from vse_tpu_torch.train.losses import ctc_rec_loss, db_loss

    g = torch.Generator().manual_seed(3)
    maps = [torch.rand((2, 64, 96), generator=g) for _ in range(3)]
    gts = [(torch.rand((2, 64, 96), generator=g) < 0.1).float(), torch.ones(2, 64, 96),
           0.3 + 0.4 * torch.rand((2, 64, 96), generator=g),
           (torch.rand((2, 64, 96), generator=g) < 0.3).float()]
    logits = torch.randn((4, 80, 69), generator=g) * 2
    labels = torch.randint(1, 69, (4, 20), generator=g)
    labels[0, :6] = torch.tensor([3, 3, 3, 4, 4, 7])
    lengths = torch.tensor([6, 20, 1, 12])
    res = {}
    for dev in ("cpu", cuda):
        ms = [m.to(dev).requires_grad_() for m in maps]
        total, _ = db_loss(*ms, *(t.to(dev) for t in gts))
        lg = logits.to(dev).requires_grad_()
        ctc = ctc_rec_loss(lg, labels.to(dev), lengths.to(dev))
        grads = torch.autograd.grad(total + ctc, ms + [lg])
        res[str(dev)] = (total.item(), ctc.item(), [gr.cpu() for gr in grads])
    (d0, c0, g0), (d1, c1, g1) = res.values()
    assert d1 == pytest.approx(d0, rel=1e-5) and c1 == pytest.approx(c0, rel=1e-5)
    for a, b in zip(g0, g1):
        assert (a - b).abs().max() <= 1e-3 * a.abs().max()


STEP_LR = {"rec": 1e-3, "det": 5e-4}


def _step_on(dev, which):
    """Two steps of ``rec_step`` / ``det_step`` from equal weights, on a
    schedule with a warmup of 1: the first at lr 0 (optax's warmup starts at
    0), the second at the full lr. Returns the losses, and for each step the
    gradients the optimizer received, its state and the trainable weights
    before it (on the CPU); then the weights after and the state dict."""
    from vse_tpu_torch.models.crnn import CRNNRecognizer
    from vse_tpu_torch.models.db_detector import DBDetector
    from vse_tpu_torch.train import optim
    from vse_tpu_torch.train.pretrain import (
        det_step, flax_init, rec_optimizer, rec_step, trainable,
    )

    g = torch.Generator().manual_seed(5)
    if which == "rec":
        model = flax_init(CRNNRecognizer(68), 0).to(dev)
        opt = optim.Optimizer(rec_optimizer(STEP_LR[which], 1, 300), trainable(model))
        x = torch.randn((4, 48, 160, 3), generator=g).to(dev)
        labels = torch.randint(1, 69, (4, 8), generator=g).to(dev)
        lengths = torch.tensor([8, 3, 5, 1], device=dev)
        step = lambda: rec_step(model, opt, x, labels, lengths).item()  # noqa: E731
    else:
        model = flax_init(DBDetector("mobile", train_outputs=True), 0).to(dev)
        # det_optimizer's chain with a warmup of 1
        opt = optim.Optimizer(
            optim.adamw(optim.warmup_cosine_decay_schedule(0, STEP_LR[which], 1, 300)),
            trainable(model))
        batch = {"det_images": torch.randn((2, 64, 64, 3), generator=g),
                 "gt_shrink": (torch.rand((2, 64, 64), generator=g) < 0.2).float(),
                 "gt_shrink_mask": torch.ones(2, 64, 64),
                 "gt_thresh": 0.3 + 0.4 * torch.rand((2, 64, 64), generator=g),
                 "gt_thresh_mask": (torch.rand((2, 64, 64), generator=g) < 0.4).float()}
        batch = {k: v.to(dev) for k, v in batch.items()}
        step = lambda: det_step(model, opt, batch)[0].item()  # noqa: E731
    seen = []
    real = opt.step

    def spy(grads):
        seen.append(([gr.detach().cpu().clone() for gr in grads], optim.state_to_flat(opt.state),
                     [p.detach().cpu().clone() for p in opt.params]))
        real(grads)

    opt.step = spy
    losses = [step() for _ in range(2)]
    after = [p.detach().cpu().clone() for p in opt.params]
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    return (losses, seen, after, opt.tx,
            {k: v.cpu() for k, v in model.state_dict().items()}, names)


def _check_steps(cpu, card, lr):
    """The card's two steps against the CPU's. Losses rtol 1e-4; the first
    step's gradients, each tensor within 1e-3 of its own largest CPU value
    (4.0e-5 at worst on an H100), or of the model's largest where its own
    is at most 1e-4 of that: the tensors whose gradient is 0 in exact
    arithmetic (``test_torch_train_models.py``: biases before a BatchNorm,
    and expansion BatchNorm scales that only the epsilon keeps from 0, at
    2e-5 of the largest or less; the others are at least 2.1e-4 of it);
    the running statistics rtol 1e-4. The update: the card's weights after the second step equal the
    CPU optimizer's step on the card's own gradients and state, within 1e-6
    (so cuDNN's sign flips of near-zero gradients, which Adam turns into
    full steps, do not enter), and that step moved some weight by over
    lr / 2. Returns the largest gradient error relative to its bound."""
    from vse_tpu_torch.train import optim

    (l0, seen0, _, _, s0, names), (l1, seen1, after1, tx, s1, _) = cpu, card
    assert l1 == pytest.approx(l0, rel=1e-4)
    want, got = seen0[0][0], seen1[0][0]
    gmax = max(float(w.abs().max()) for w in want)
    worst = (0.0, "")
    for name, w, gr in zip(names, want, got):
        scale = float(w.abs().max())
        if scale <= 1e-4 * gmax:
            assert re.search(r"(project\.bn\.bias|up1\.bias|expand\.bn\.weight)$", name), name
            scale = gmax
        worst = max(worst, (float((gr - w).abs().max()) / (1e-3 * scale), name))
    assert worst[0] <= 1.0, worst
    grads, state, before = seen1[1]
    ref = optim.Optimizer(tx, [p.clone() for p in before])
    ref.state = optim.state_from_flat(state, ref.state)
    ref.step(grads)
    moved = max(float((a - b).abs().max()) for a, b in zip(ref.params, before))
    assert moved > lr / 2, moved
    for a, b in zip(after1, ref.params):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for k in s0:
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(s1[k], s0[k], rtol=1e-4, atol=1e-5)
    return worst[0]


@pytest.mark.parametrize("which", ["rec", "det"])
def test_train_step_on_the_card_equals_cpu(cuda, which):
    """One rec step and one det step on the card against the CPU from
    equal weights (``_check_steps`` states the tolerances)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = _check_steps(_step_on("cpu", which), _step_on(cuda, which), STEP_LR[which])
    print(f"{which}: largest gradient error {worst:.3f} of its bound")


def test_train_augment_apply_on_the_card_equals_cpu(cuda):
    from vse_tpu_torch.train.device_loop import make_rec_augment

    aug = make_rec_augment(48, 320)
    x = torch.from_numpy(np.load(os.path.join(SMOKE_FIXTURE, "train_rec_en.npz"))["images"][:4]
                         .astype(np.float32))
    for seed in range(4):
        draws = aug.draw(torch.Generator().manual_seed(seed), 4, "cpu")
        want = aug.apply(draws, x)
        got = aug.apply({k: v.to(cuda) for k, v in draws.items()}, x.to(cuda)).cpu()
        assert (got - want).abs().max() <= 0.02


def _band_frames(n):
    from vse_tpu_torch.video.synth import load_fixture

    bands, _ = load_fixture()
    frames = [bands[f"band{i}"] for i in range(3)] + [np.zeros_like(bands["band0"])] * n
    return np.stack(frames[:n])


@pytest.mark.parametrize("replicas", [1, 2])
def test_meshed_engine_on_the_card_equals_the_single_engine(cuda, replicas):
    """``OcrEngine(mesh=...)`` at the card count (one replica) and with two
    replicas on ``cuda:0``, at B 5 (not a multiple of 2): the same boxes
    and texts as the single-device engine, the scores within 1e-6 (a piece
    of 3 frames runs the rec on 24 crops, the single engine on 40: cuDNN's
    sums for another batch differ in the last bits; at the keyframe clip's
    45 samples, 23 + 23 against 45, they were equal, chip_smoke phase 13);
    each replica launches K1 once a chunk."""
    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.parallel.sharding import make_mesh
    from vse_tpu_torch.pipeline.ocr_engine import OcrEngine

    mesh = make_mesh() if replicas == 1 else make_mesh(2, devices=["cuda:0", "cuda:0"])
    assert mesh.shape["data"] == (torch.cuda.device_count() if replicas == 1 else 2)
    cfg = VseConfig(language="en")
    meshed = OcrEngine("en", config=cfg, device="cuda", mesh=mesh)
    single = OcrEngine("en", config=cfg, device="cuda")
    frames = _band_frames(5)
    k1.launches = 0
    got = meshed.predict_batch(frames)
    assert k1.launches == sum(r.k1_launches for r in meshed.replicas) == len(meshed.replicas)
    want = single.predict_batch(frames)
    assert [(box, [t for t, _ in res]) for box, res in got] == \
        [(box, [t for t, _ in res]) for box, res in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose([p for _, p in g], [p for _, p in w], rtol=0, atol=1e-6)
    assert [t for _, res in got[:3] for t, _ in res] == [
        "hellofromthenewportonthecard", "asecondlineoftextcomeshere",
        "andthisisthelastcueoftheclip"]


def _joint_steps(device):
    """5 joint steps at the tiny shapes from the JAX init, on ``device``
    (a (1, 1) mesh: ``shard_state`` moves the state there)."""
    import json

    from vse_tpu_torch.parallel.sharding import make_mesh
    from vse_tpu_torch.train import steps as S

    with open(os.path.join(SMOKE_FIXTURE, "reference_joint.json"), encoding="utf-8") as f:
        ref = json.load(f)
    with np.load(os.path.join(SMOKE_FIXTURE, "train_joint_init.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with np.load(os.path.join(SMOKE_FIXTURE, "reference_joint_tiny.npz")) as z:
        batch = {k[6:]: z[k] for k in z.files if k.startswith("batch/")}
    det, rec = S.make_models(ref["vocab"], device=device)
    state, tx = S.load_state(det, rec, {k[4:]: v for k, v in flat.items() if k.startswith("det/")},
                             {k[4:]: v for k, v in flat.items() if k.startswith("rec/")},
                             lr=ref["lr"])
    mesh = make_mesh(1, 1, devices=[device])
    step = S.make_train_step(det, rec, tx, mesh)
    state = S.shard_state(mesh, state)
    local = S.place_batch(mesh, batch)
    losses = []
    for _ in range(ref["steps"]):
        state, metrics = step(state, local)
        losses.append(float(metrics["loss"]))
    return losses, ref["tiny"]["f32"]["loss"]


def test_joint_step_on_the_card_equals_cpu(cuda):
    """5 joint det + rec steps at the tiny shapes on the card and on the
    CPU from the JAX init: the losses within rtol 1e-3 of each other and of
    the JAX f32 step's (``tests/test_torch_train_steps.py``). TF32 is on
    at the start, as in a fresh process (cuDNN's default): the step turns
    it off itself."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    card, want = _joint_steps(cuda)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    cpu, _ = _joint_steps("cpu")
    np.testing.assert_allclose(card, cpu, rtol=1e-3)
    np.testing.assert_allclose(card, want, rtol=1e-3)


def test_trace_context_on_the_card_names_both_kernels(cuda, tmp_path):
    """A Chrome trace of 8 K1 and 8 K2 launches under an ``annotate`` span,
    each K2 launch in a ``scan.k2`` span as the scan makes it: the span, 16
    host launch records in it, and device records naming both kernels. The
    profiler drops a device record now and then ("Out-of-range" in its log;
    see ``assert_only_kernels``), so the names are required among the
    records it kept, the count from the host records. The recorder's
    ``scan.k2`` spans are on the profiler's clock: each K2 launch record
    lies in one of them, and each K2 device record starts after the start
    of the span whose launch it is (tied through the correlation id)."""
    import json

    from vse_tpu_torch.utils import tracing
    from vse_tpu_torch.utils.tracing import annotate, trace_context

    logits = logits_with_ties(8, 80, 69, 0).to(cuda)
    frames = torch.zeros((32, 104, 1280, 3), dtype=torch.uint8, device=cuda)
    k2.scan_stats_u8(frames)  # built and warm
    tracing.clear()
    with trace_context(str(tmp_path)) as path:
        with annotate("vse_card_span"):
            for _ in range(8):
                k1.ctc_greedy_decode(logits)
                with annotate("scan.k2"):
                    k2.scan_stats_u8(frames)
    spans = [s for s in tracing.spans() if s.name == "scan.k2"]
    tracing.clear()
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    span = [e for e in events if e.get("name") == "vse_card_span" and e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]
    assert len(span) == 1
    launches = [e for e in events if e.get("cat") == "cuda_runtime" and "aunch" in e["name"]
                and span[0]["ts"] <= e["ts"] <= span[0]["ts"] + span[0]["dur"]]
    assert len(launches) == 16
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("ctc_decode_fused_kernel" in n for n in names)
    assert any("keyframe_stats_kernel" in n for n in names)

    base = trace.get("baseTimeNanoseconds", 0)
    ns = lambda ts: base + round(ts * 1000)  # noqa: E731
    assert len(spans) == 8
    launch_at = {e["args"]["correlation"]: ns(e["ts"]) for e in launches}
    k2_records = [e for e in events if e.get("cat") == "kernel"
                  and "keyframe_stats_kernel" in e["name"]]
    assert k2_records
    for e in k2_records:
        t = launch_at[e["args"]["correlation"]]
        (owner,) = [s for s in spans if s.start_ns <= t <= s.end_ns]
        assert ns(e["ts"]) >= owner.start_ns


def test_recorded_keyframe_run_on_the_card(cuda, tmp_path):
    """A keyframe run of a 200-frame clip with a fresh engine, recording:
    its SRT equals the run's with recording off, and the spans that only
    the card has are there too: ``graph.capture`` on the main thread (each
    OCR shape's first call), ``feed.ring_wait`` on the feeder's (a batch
    staged into a pinned buffer whose last copy it waits on: 7 batches
    through a ring of 4)."""
    from collections import defaultdict

    from vse_tpu_torch.core.config import VseConfig
    from vse_tpu_torch.core.subtitle_area import SubtitleArea
    from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
    from vse_tpu_torch.utils import tracing

    clip = tiny_clip("band0", n=200)
    cfg = VseConfig(language="en")
    area = SubtitleArea(120, 224, 0, 1280)
    srts = []
    tracing.record(False)
    tracing.clear()
    try:
        for on in (True, False):
            tracing.record(on)
            ex = SubtitleExtractor(clip, area, cfg, device="cuda")  # a fresh engine: captures
            ex.subtitle_output_path = str(tmp_path / f"run{int(on)}.srt")
            ex.append_output = lambda *a: None
            with open(ex.run(), encoding="utf-8") as f:
                srts.append(f.read())
            tracing.record(False)
        spans = tracing.spans()
    finally:
        tracing.record(False)
        tracing.clear()
    assert srts[0] == srts[1] and srts[0].count("-->") == 1
    by_thread = defaultdict(set)
    for s in spans:
        by_thread[s.thread].add(s.name)
    main = next(s.thread for s in spans if s.name == "extract")
    assert {"graph.capture", "ocr.det", "scan.k2", "feed.wait"} <= by_thread[main]
    feeder = next(s.thread for s in spans if s.name == "feed.stage")
    assert feeder != main and {"feed.ring_wait", "feed.upload"} <= by_thread[feeder]
    assert len({s.clip for s in spans}) == 1
