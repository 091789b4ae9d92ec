"""The port's tracing exporter (``vse_tpu_torch/utils/tracing.py``):
``trace_context`` / ``annotate`` on the CPU (a Chrome trace naming the
span, nothing without a directory). The recorder's own tests are in
``test_torch_tracing.py``."""

import json
import os

import torch

from vse_tpu_torch.utils.tracing import annotate, trace_context


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
