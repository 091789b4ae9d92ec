"""The port's recorder of spans and counters (``vse_tpu_torch/utils/tracing.py``)
on the CPU.

- Off (the default), ``annotate`` and ``count`` keep nothing, and no span
  becomes a ``record_function`` under a profiler someone else runs; nor
  does a recorded span outside ``trace_context``.
- Recording keeps each span's parent, thread, clip and attributes, and
  each counter; 8 threads of 200 spans lose none.
- Under ``trace_context`` a span's ``record_function`` event lies inside
  the span's own stamps: both are on the profiler's clock.
- A keyframe run and a per-frame run of short in-memory clips, each once
  off and once recording: the SRTs are byte-equal; every stage of the path
  records its span on its own thread (the main thread, the frame stream's
  feeder, the decode thread) under the run's clip id; and the counters
  ``ocr.crops`` / ``ocr.boxes`` sum the box slots and the boxes of the
  arrays ``ocr_arrays`` returned, and ``decode.copy_bytes`` /
  ``decode.frame_bytes`` read the share of each frame the stream's reader
  copied (nothing of an in-memory clip's full-width rows, which it hands on
  as a view). ``feed.ring_wait`` and ``graph.capture``
  exist on the card only (pinned buffers, CUDA graphs);
  ``tests/test_torch_cuda.py`` covers them there.
"""

import json
import os
import sys
import threading
from collections import defaultdict

import numpy as np
import pytest
import torch

from _torch_helpers import two_threads  # noqa: F401
from vse_tpu_torch.core.config import Mode, VseConfig
from vse_tpu_torch.core.subtitle_area import SubtitleArea
from vse_tpu_torch.pipeline.extractor import SubtitleExtractor
from vse_tpu_torch.pipeline.ocr_engine import OcrEngine
from vse_tpu_torch.utils import tracing
from vse_tpu_torch.utils.tracing import annotate, count, trace_context
from vse_tpu_torch.video.decode import InMemoryVideo
from vse_tpu_torch.video.synth import SMOKE_FIXTURE, compose_frames, load_fixture, recipe_area

# the profiler converts its own clock to Unix time with an error of a few
# microseconds (about 6 us in a CPU probe on torch 2.13)
CLOCK_SLACK_NS = 50_000

OCR = {"ocr.step", "ocr.letterbox", "ocr.det", "ocr.postprocess", "ocr.crops", "ocr.rec",
       "ocr.k1", "ocr.fetch", "ocr.format"}
DECODE_THREAD = {"decode.read", "decode.copy", "decode.put_wait"}
FEEDER_THREAD = {"stream.wait", "stream.assemble", "feed.stage", "feed.upload", "feed.put_wait"}
MAIN_THREAD = {
    "keyframe": OCR | {"extract", "pass.scan", "pass.ocr", "pass.post", "feed.wait", "scan.k2",
                       "scan.fetch", "scan.find_spans", "decode.samples"},
    "perframe": OCR | {"extract", "pass.ocr", "pass.post", "feed.wait", "tracker.feed",
                       "tracker.finish"},
}


@pytest.fixture
def recorder():
    tracing.record(False)
    tracing.clear()
    yield
    tracing.record(False)
    tracing.clear()


@pytest.mark.parametrize("recording", [False, True])
def test_no_record_function_outside_trace_context(recorder, recording):
    tracing.record(recording)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("vse_probe_outer", frames=np.zeros((2, 3))):
            with annotate("vse_probe_inner"):
                count("vse_probe_count", 3)
                torch.ones(8).sum()
    assert not [e for e in prof.events() if e.name.startswith("vse_probe")]
    names = [s.name for s in tracing.spans()]
    assert names == (["vse_probe_inner", "vse_probe_outer"] if recording else [])
    assert len(tracing.counters()) == (1 if recording else 0)


def test_off_is_one_shared_no_op(recorder):
    assert annotate("a") is annotate("b", batch=1)
    with tracing.clip() as cid:
        assert cid is None
    assert tracing.carry(len) is len


def test_recording_keeps_parents_threads_clips_attrs_and_counters(recorder):
    tracing.record(True)
    main = threading.get_ident()
    seen = {}

    def worker():
        seen["thread"] = threading.get_ident()
        with annotate("child.thread", batch=7):
            count("things", np.int64(5))

    with annotate("outside"):
        pass
    with tracing.clip() as cid:
        with annotate("root", video="v.mp4"):
            with annotate("mid", input=torch.zeros(4, 5)):
                with annotate("leaf"):
                    count("things", 2)
            t = threading.Thread(target=tracing.carry(worker))
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    by = {s.name: s for s in tracing.spans()}
    assert by["outside"].clip is None and by["outside"].parent is None
    assert by["root"].parent is None and by["root"].attrs == {"video": "v.mp4"}
    assert by["mid"].parent == by["root"].id and by["mid"].attrs == {"input": (4, 5)}
    assert by["leaf"].parent == by["mid"].id
    assert by["child.thread"].parent is None and by["child.thread"].attrs == {"batch": 7}
    assert {s.clip for n, s in by.items() if n != "outside"} == {cid}
    assert {by[n].thread for n in ("outside", "root", "mid", "leaf")} == {main}
    assert by["child.thread"].thread == seen["thread"] != main
    for s in by.values():
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = next(q for q in by.values() if q.id == s.parent)
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    c = tracing.counters()
    assert [(x.name, x.n, x.clip) for x in c] == [("things", 2, cid), ("things", 5, cid)]
    assert [x.thread for x in c] == [main, seen["thread"]]
    assert by["leaf"].start_ns <= c[0].t_ns <= by["leaf"].end_ns
    # the clip scope ends with its block; the next one gets a new id
    assert tracing.carry(len) is len
    with tracing.clip() as again:
        assert again != cid


def test_recording_is_thread_safe(recorder):
    tracing.record(True)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(200):
                with annotate(f"t{k}", i=i):
                    count(f"t{k}", 1)

        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    spans = tracing.spans()
    assert len(spans) == 1600 and len({s.id for s in spans}) == 1600
    for k in range(8):
        mine = [s for s in spans if s.name == f"t{k}"]
        assert sorted(s.attrs["i"] for s in mine) == list(range(200))
        assert len({s.thread for s in mine}) == 1
    assert sum(c.n for c in tracing.counters()) == 1600


def test_spans_are_on_the_profilers_clock(recorder, tmp_path, monkeypatch):
    monkeypatch.delenv("VSE_TRACE_DIR", raising=False)
    with trace_context(str(tmp_path)) as path:
        for _ in range(3):
            with annotate("vse_clock_probe"):
                torch.ones(128, 128).matmul(torch.ones(128, 128)).sum()
    assert not tracing.recording()  # as it was before the block
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    events = sorted(e["ts"] for e in trace["traceEvents"]
                    if e.get("name") == "vse_clock_probe" and e.get("ph") == "X")
    durs = {e["ts"]: e["dur"] for e in trace["traceEvents"] if e.get("name") == "vse_clock_probe"}
    spans = sorted(tracing.spans(), key=lambda s: s.start_ns)
    assert len(events) == len(spans) == 3
    for ts, s in zip(events, spans):
        a = base + round(ts * 1000)
        b = a + round(durs[ts] * 1000)
        assert s.start_ns - CLOCK_SLACK_NS <= a <= b <= s.end_ns + CLOCK_SLACK_NS, (a, b, s)


# --- the two paths, each run once off and once recording ------------------------------


def keyframe_case():
    bands, recipe = load_fixture()
    recipe = dict(recipe, n_frames=84, cues=[
        dict(recipe["cues"][0], first=6, last=37),
        dict(recipe["cues"][1], first=46, last=77),
    ])
    cfg = VseConfig(language="en", word_segmentation=False)
    return (compose_frames(bands, recipe), recipe_area(recipe), cfg,
            OcrEngine(language="en", config=cfg, device="cpu"))


def perframe_case():
    with open(os.path.join(SMOKE_FIXTURE, "reference_accurate.json"), encoding="utf-8") as f:
        small = json.load(f)["small"]
    cfg = VseConfig(language="en", mode=Mode.ACCURATE, **small["config"])
    frames = compose_frames(load_fixture(recipe="recipe_fps.json")[0], small["recipe"])
    return (frames, SubtitleArea(*small["recipe"]["area"]), cfg,
            OcrEngine("en", Mode.ACCURATE, cfg, device="cpu"))


CASES = {"keyframe": keyframe_case, "perframe": perframe_case}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request, tmp_path_factory):
    """(path, the SRT off, the SRT recording, spans, counters, the arrays of
    every ocr_arrays call while recording, the main thread)."""
    tmp = tmp_path_factory.mktemp(request.param)
    frames, area, cfg, engine = CASES[request.param]()
    arrays = []
    orig = engine.ocr_arrays

    def keep(chunk):
        out = orig(chunk)
        if tracing.recording():
            arrays.append(out)
        return out

    engine.ocr_arrays = keep
    srts = []
    tracing.record(False)
    tracing.clear()
    try:
        for on in (False, True):
            tracing.record(on)
            ex = SubtitleExtractor(InMemoryVideo(frames, 25.0, str(tmp / f"clip{int(on)}.avi")),
                                   area, cfg, engine=engine, device="cpu")
            ex.append_output = lambda *a: None
            with open(ex.run(), encoding="utf-8") as f:
                srts.append(f.read())
            tracing.record(False)
        spans, counters = tracing.spans(), tracing.counters()
    finally:
        tracing.record(False)
        tracing.clear()
    return request.param, srts[0], srts[1], spans, counters, arrays, threading.get_ident()


def test_srt_is_byte_equal_recording_or_not(runs):
    path, off, on, *_ = runs
    assert on == off and off.count("-->") == 2


def test_every_stage_records_its_span_on_its_thread(runs):
    path, _, _, spans, _, _, main = runs
    by_thread = defaultdict(set)
    for s in spans:
        by_thread[s.thread].add(s.name)
    assert by_thread.pop(main) == MAIN_THREAD[path]
    # the feeder and the decode thread of the one frame stream
    assert sorted(by_thread.values(), key=len) == [DECODE_THREAD, FEEDER_THREAD]
    (clip,) = {s.clip for s in spans if s.name == "extract"}
    assert clip is not None and {s.clip for s in spans} == {clip}


def test_spans_nest_under_the_run(runs):
    path, _, _, spans, _, _, main = runs
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.thread == s.thread and p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    (root,) = [s for s in spans if s.parent is None and s.thread == main]
    assert root.name == "extract" and root.attrs["video"].endswith("clip1.avi")

    def chain(s):
        out = []
        while s.parent is not None:
            s = by_id[s.parent]
            out.append(s.name)
        return out

    det = next(s for s in spans if s.name == "ocr.det")
    assert chain(det) == ["ocr.step", "pass.ocr", "extract"]
    assert det.attrs["input"][0] == next(s for s in spans if s.name == "ocr.step").attrs["frames"][0]
    waits = [s.attrs["batch"] for s in spans if s.name == "feed.wait"]
    assert waits == list(range(len(waits)))
    assembled = sorted(s.attrs["batch"] for s in spans if s.name == "stream.assemble")
    assert assembled == list(range(len(waits) - 1))  # the last wait meets the stream's end


def test_counters_sum_the_arrays_ocr_arrays_returned(runs):
    path, _, _, _, counters, arrays, main = runs
    crops = [c.n for c in counters if c.name == "ocr.crops"]
    boxes = [c.n for c in counters if c.name == "ocr.boxes"]
    valids = [a[2] for a in arrays]
    assert len(crops) == len(boxes) == len(valids) > 0
    assert crops == [v.size for v in valids] and boxes == [int(v.sum()) for v in valids]
    assert 0 < sum(boxes) < sum(crops)
    assert {c.thread for c in counters if c.name.startswith("ocr.")} == {main}


def test_decode_counters_read_the_share_of_each_frame_copied(runs):
    path, _, _, spans, counters, _, main = runs
    frames, area, cfg, _ = CASES[path]()
    n, h, w, _ = frames.shape
    if path == "keyframe":  # the scan's stream: the area
        region = frames[0, area.ymin : area.ymax, area.xmin : area.xmax]
    else:  # the per-frame stream: the upload band at full width (here the whole frame)
        margin = max(32, cfg.subtitle_area_deviation_pixel)
        region = frames[0, max(0, area.ymin - margin) : min(h, area.ymax + margin)]
    # rows at full width of an in-memory frame are a contiguous view: the
    # reader hands them on and copies nothing (both cases here)
    share = 0 if region.flags.c_contiguous else region.size / frames[0].size
    copied = [c for c in counters if c.name == "decode.copy_bytes"]
    whole = [c for c in counters if c.name == "decode.frame_bytes"]
    assert [c.n for c in whole] == [h * w * 3] * n
    assert sum(c.n for c in copied) == round(share * sum(c.n for c in whole))
    (decode,) = {s.thread for s in spans if s.name == "decode.copy"}
    assert {c.thread for c in copied + whole} == {decode} != {main}
