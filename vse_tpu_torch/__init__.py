"""vse_tpu_torch — the PyTorch/CUDA port of vse_tpu for one NVIDIA H100.

The port grows beside the JAX package, which stays the reference it is held
against. This slice covers the main path, ``extract --area --mode fast``:
keyframe scan (hand-written CUDA kernel K2), PP-OCRv3 mobile DB detection,
the mobile CRNN, and greedy CTC decode (hand-written CUDA kernel K1).

The package imports torch and never jax, and imports nothing of vse_tpu.
Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"`` (see ``device.resolve_device``).
"""

__version__ = "0.1.0"
