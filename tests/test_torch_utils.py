"""The port's stage metrics and tracing (``vse_tpu_torch/utils/``): the
counters against the JAX package's on a patched clock, and
``trace_context`` / ``annotate`` on the CPU (a Chrome trace naming the
span, nothing without a directory)."""

import json
import os
import threading

import torch

import vse_tpu.utils as jax_utils
import vse_tpu.utils.metrics as jax_metrics
import vse_tpu_torch.utils as port_utils
import vse_tpu_torch.utils.metrics as port_metrics
from vse_tpu_torch.utils.tracing import annotate, trace_context


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


def drive(module, monkeypatch):
    monkeypatch.setattr(module.time, "perf_counter", Clock())
    timer = module.StageTimer()
    with timer.stage("det", n=8):
        pass
    with timer.stage("rec", n=64):
        pass
    with timer.stage("det", n=8):
        pass
    timer.get("idle")
    return timer


def test_stage_timer_reports_as_jax(monkeypatch):
    ours = drive(port_metrics, monkeypatch)
    theirs = drive(jax_metrics, monkeypatch)
    assert ours.report() == theirs.report()
    assert ours.as_dict() == theirs.as_dict() == {"det": 32.0, "rec": 256.0, "idle": 0.0}
    t = port_metrics.Throughput("x")
    t.add(3, 1.5)
    assert str(t) == str(jax_metrics.Throughput("x", 3, 1.5)) == "x: 3 items, 2.0/s"
    assert port_utils.__all__ == jax_utils.__all__


def test_stage_timer_is_thread_safe():
    timer = port_metrics.StageTimer()

    def work():
        for _ in range(200):
            with timer.stage("s", n=1):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert timer.get("s").items == 1600


def test_trace_context_writes_a_chrome_trace_with_the_span(tmp_path, monkeypatch):
    monkeypatch.delenv("VSE_TRACE_DIR", raising=False)
    with trace_context(str(tmp_path)) as path:
        with annotate("vse_span_under_test"):
            torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    assert os.path.dirname(path) == str(tmp_path)
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "vse_span_under_test" for e in events)
    # the directory may come from VSE_TRACE_DIR, as in the JAX package
    monkeypatch.setenv("VSE_TRACE_DIR", str(tmp_path / "env"))
    with trace_context() as path:
        torch.ones(4).sum()
    assert os.path.exists(path) and path.startswith(str(tmp_path / "env"))


def test_trace_context_does_nothing_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("VSE_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with trace_context() as path:
        with annotate("nothing"):
            torch.ones(4).sum()
    assert path is None and os.listdir(tmp_path) == []
    assert torch.autograd.profiler._is_profiler_enabled is False
