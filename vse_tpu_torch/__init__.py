"""vse_tpu_torch — the PyTorch/CUDA port of vse_tpu for one NVIDIA H100.

The port grows beside the JAX package, which stays the reference it is held
against. It runs ``extract`` in modes fast, auto and accurate: the keyframe
scan (hand-written CUDA kernel K2) or per-frame detection, the PP-OCRv3
mobile or the ResNet-50 server DB detector, the mobile CRNN, and greedy CTC
decode (hand-written CUDA kernel K1); the batch surface, the sync re-timer,
the GUI, training (``train/``, the joint det + rec step included), several
devices (``parallel/``: engine replicas over a mesh, ``torch.distributed``
processes), SRT scoring (``eval.py``) and tracing (``utils/``).

The package imports torch and never jax, and imports nothing of vse_tpu.
Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"`` (see ``device.resolve_device``).
"""

__version__ = "0.1.0"
