"""Device resolution for the port's entry points.

Entry points (``SubtitleExtractor``, ``OcrEngine``, ``cli extract``) take
``device="cuda"`` by default and raise when CUDA is absent. Only an explicit
``device="cpu"`` runs on the CPU, where each kernel wrapper uses its plain
PyTorch version. There is no global kernel switch: a wrapper launches its
kernel for a CUDA tensor and uses the plain version only for a CPU tensor.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Validate the requested device and return it as a ``torch.device``.

    On CUDA this also pins float32 math to full precision: cuDNN would run
    f32 convolutions (and RNNs) in TF32 by default, which keeps ~3 decimal
    digits, while the port's emulation of the reference's bf16 models
    (``models/bf16.py``) needs the f32 sums of bf16 values that the
    reference computes."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port's "
                "plain PyTorch path on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
