"""A model's forward replayed as a CUDA graph, one graph per input shape.

The emulation of the reference's bf16 numerics (``models/bf16.py``) issues
many small kernels: a rounding after each bf16 op and the BiLSTM's 80
steps, about 6,000 launches an OCR chunk. Eager, the host's launch cost
holds the card idle; a graph replays the same kernels in one launch. The
kernels and their order are those of the eager forward, so the results are
the same bit for bit (``tests/test_torch_cuda.py``). The CTC decode (K1)
stays outside the graph, so that its wrapper counts each launch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn


class GraphedForward:
    """Call ``module`` on a tensor: eagerly on the CPU; on CUDA by replaying
    a graph captured at the first call with that shape and dtype. The
    module's weights must not change afterwards (the graph reads them in
    place)."""

    def __init__(self, module: nn.Module):
        self.module = module
        self.graphs: Dict[Tuple, Tuple[torch.cuda.CUDAGraph, torch.Tensor, torch.Tensor]] = {}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not x.is_cuda:
            return self.module(x)
        key = (tuple(x.shape), x.dtype, x.device)
        if key not in self.graphs:
            self.graphs[key] = self._capture(x)
        graph, static_in, static_out = self.graphs[key]
        static_in.copy_(x)
        graph.replay()
        return static_out.clone()

    def _capture(self, x: torch.Tensor):
        static_in = x.clone()
        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):  # warm-up: cuDNN / cuBLAS set up here
            self.module(static_in)
        torch.cuda.current_stream(x.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: the feed's thread keeps uploading during a capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static_out = self.module(static_in)
        return graph, static_in, static_out
