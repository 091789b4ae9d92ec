"""Fixtures shared by the port's torch-heavy CPU test files.

Import them into a test module by name (pytest finds fixtures among a
module's names, autouse ones included):

    from _torch_helpers import small_chunks, two_threads  # noqa: F401
"""

from __future__ import annotations

import pytest
import torch

from vse_tpu_torch.core import config as config_module
from vse_tpu_torch.core.config import VseConfig


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads while the importing file runs: the tier-1 run
    puts six test workers on one machine, and the bf16 emulation's thousands
    of small ops a chunk stall when every worker's thread pool wants every
    core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_chunks(monkeypatch):
    """The CLI's ``VseConfig`` with OCR chunks of 2 frames (the CLI has no
    flag for it): 16 crops of 21,060-class logits at a time, not 64."""
    class SmallChunks(VseConfig):
        def __init__(self, **kw):
            super().__init__(**{"max_batch_size": 2, **kw})

    monkeypatch.setattr(config_module, "VseConfig", SmallChunks)
