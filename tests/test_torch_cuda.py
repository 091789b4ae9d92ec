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

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from vse_tpu_torch.kernels import ctc_decode as k1
from vse_tpu_torch.kernels import keyframe as k2
from vse_tpu_torch.pipeline.feed import device_prefetch
from vse_tpu_torch.video.decode import FrameBatch
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


def distinct_batches(n, shape):
    """Batches whose every byte depends on the batch and its position."""
    base = np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape)
    for i in range(n):
        yield FrameBatch(((base * 7 + i * 131) % 251).astype(np.uint8),
                         np.arange(shape[0]) + 1, np.ones(shape[0], bool))


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("hold", [True, False])
def test_device_prefetch_equals_a_synchronous_upload(cuda, depth, hold):
    """20 batches of distinct contents, cropped on the host, through the
    pinned ring and the side stream. The consumer's stream is kept busy
    before each read, so the feeder runs ahead and the pinned buffers and
    freed device batches are reused under pressure: each read must still
    see its own batch."""
    shape = (32, 120, 1280, 3)
    crop = lambda f: f[:, 8:112, :, :]  # noqa: E731
    hosts = [np.ascontiguousarray(crop(b.frames)) for b in distinct_batches(20, shape)]
    got, kept = [], []
    for b, dev in device_prefetch(distinct_batches(20, shape), cuda, depth=depth,
                                  transform=crop):
        assert dev.is_cuda and dev.shape == (32, 104, 1280, 3) and dev.is_contiguous()
        torch.cuda._sleep(20_000_000)  # ~10 ms of device time before the read
        got.append(dev.double().sum())
        if hold:
            kept.append(dev)
    torch.cuda.synchronize()
    assert [g.item() for g in got] == [float(h.sum(dtype=np.float64)) for h in hosts]
    for dev, host in zip(kept, hosts):
        assert torch.equal(dev, torch.from_numpy(host).to(cuda))


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
