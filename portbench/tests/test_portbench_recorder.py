"""The readers of the program's own recorder (``recorder.py``, and the five
metric files that use it) on a made-up record: a profiled clip's window,
device intervals and recorder spans and counters with known overlaps. And
``spans/program.py``, whose loading switches the recorder on."""

import os

import pytest

from _helpers import PB

import tracer
from vse_tpu_torch.utils import tracing
from vse_tpu_torch.utils.tracing import Counter, Span

U = 10 ** 8  # 0.1 s in ns
MAIN, FEEDER, DECODE = 1, 2, 3
WINDOW = (10 * U, 20 * U)


def metric(name):
    return tracer.load_file(os.path.join(PB, "metrics", name + ".py"), "metric").read


def span(name, a, b, thread=MAIN, clip=1):
    span.ids = getattr(span, "ids", 0) + 1
    return Span(name, int(a), int(b), thread, None, clip, {}, span.ids)


SPANS = [
    # before the profiled clip: counted by the per-second metrics
    span("extract", 0, 9 * U),
    span("feed.wait", 1 * U, 4 * U),
    span("decode.copy", 2 * U, 3 * U, DECODE),
    span("stream.assemble", 3 * U, 5 * U, FEEDER),
    span("feed.stage", 6 * U, 8 * U, FEEDER),
    span("decode.copy", 9 * U, 11 * U, DECODE),  # overlaps the clip: left out
    # the profiled clip (device busy 10-12 and 15-16: idle 12-15 and 16-20)
    span("extract", 9.5 * U, 21 * U, clip=2),
    span("feed.wait", 11 * U, 13 * U, clip=2),  # idle 12-13
    span("ocr.step", 14 * U, 17 * U, clip=2),  # idle 14-15, 16-17
    span("ocr.format", 17 * U, 18 * U, clip=2),  # idle 17-18
    span("feed.wait", 12.5 * U, 14.5 * U, FEEDER, clip=2),  # not the extractor's thread
]
COUNTERS = [Counter("ocr.crops", 1, 64, MAIN, 1), Counter("ocr.boxes", 2, 8, MAIN, 1),
            Counter("ocr.crops", 3, 64, MAIN, 1), Counter("ocr.boxes", 4, 0, MAIN, 1),
            Counter("ocr.crops", 5, 8, MAIN, 2), Counter("ocr.boxes", 6, 3, MAIN, 2)]


def record(profiled=True):
    notes = [("clip#0", *WINDOW)] if profiled else []
    device = [("k", 10 * U, 12 * U, 1), ("k", 15 * U, 16 * U, 2)] if profiled else []
    return {"video_s": 2.0, "profile": {"device": device, "launches": [], "notes": notes}}


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: list(SPANS))
    monkeypatch.setattr(tracing, "counters", lambda: list(COUNTERS))


def test_readings_on_a_made_up_record(program):
    r = record()
    assert metric("feed_wait_s_per_video_s")(r) == pytest.approx(0.3 / 2)
    assert metric("frame_copy_s_per_video_s")(r) == pytest.approx((0.1 + 0.2 + 0.2) / 2)
    assert metric("idle_feed_wait_pct")(r) == pytest.approx(10.0)
    assert metric("idle_ocr_host_pct")(r) == pytest.approx(30.0)
    assert metric("rec_crops_useful_pct")(r) == pytest.approx(100.0 * 11 / 136)
    idle = metric("device_idle_pct")(r)
    assert idle == pytest.approx(70.0)
    assert metric("idle_feed_wait_pct")(r) + metric("idle_ocr_host_pct")(r) <= idle


def test_without_a_profiled_clip(program):
    r = record(profiled=False)
    assert metric("idle_feed_wait_pct")(r) is None
    assert metric("idle_ocr_host_pct")(r) is None
    # nothing to leave out: every span counts
    assert metric("feed_wait_s_per_video_s")(r) == pytest.approx((0.3 + 0.2 + 0.2) / 2)
    assert metric("rec_crops_useful_pct")(r) == pytest.approx(100.0 * 11 / 136)


def test_nothing_recorded_reads_nothing(monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: [])
    monkeypatch.setattr(tracing, "counters", lambda: [])
    for name in ("feed_wait_s_per_video_s", "frame_copy_s_per_video_s", "idle_feed_wait_pct",
                 "idle_ocr_host_pct", "rec_crops_useful_pct"):
        assert metric(name)(record()) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.delattr(tracing, "spans")
    monkeypatch.delattr(tracing, "counters")
    monkeypatch.delattr(tracing, "record")
    for name in ("feed_wait_s_per_video_s", "frame_copy_s_per_video_s", "idle_feed_wait_pct",
                 "idle_ocr_host_pct", "rec_crops_useful_pct"):
        assert metric(name)(record()) is None
    tracer.load_file(os.path.join(PB, "spans", "program.py"), "spans")  # does not raise


def test_loading_the_program_span_file_switches_recording_on():
    tracing.record(False)
    try:
        mod = tracer.load_file(os.path.join(PB, "spans", "program.py"), "spans")
        assert mod.WRAPS == [] and tracing.recording()
        with tracing.annotate("x"):
            pass
        assert [s.name for s in tracing.spans()] == ["x"]
    finally:
        tracing.record(False)
        tracing.clear()
