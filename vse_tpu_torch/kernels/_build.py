"""Build and load the port's CUDA kernels.

All ``vse_tpu_torch/csrc/*.cu`` sources compile in ONE ``nvcc`` call into one
shared library with a plain C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build>/libvse_kernels_<hash>.so csrc/*.cu

No PyTorch headers are included, so the build takes seconds (PyTorch's own
extension builder takes minutes and needs ninja). The library is built at
first use into ``vse_tpu_torch/_build/`` (listed in ``.gitignore``), named by
a hash of the sources and flags so an edited source rebuilds. Nothing here
runs at import time: the CPU tests import every kernel module on a machine
without nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from typing import List

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclass
class BuildInfo:
    path: str
    seconds: float  # 0.0 when an up-to-date library was reused
    log: str  # nvcc's output (ptxas register / spill report)


def _sources() -> List[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's CUDA "
        "kernels are built from vse_tpu_torch/csrc at first use"
    )


@functools.lru_cache(maxsize=None)
def build() -> BuildInfo:
    """Compile the kernel library if no up-to-date build exists."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libvse_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return BuildInfo(so, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name, then rename: another process never loads a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, so)
    return BuildInfo(so, seconds, log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's C signature set
    (pointers and the stream as c_void_p: ctypes would pass a bare Python
    int as a 32-bit int and cut the pointer)."""
    lib = ctypes.CDLL(build().path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vse_ctc_greedy_decode.argtypes = [p] + [i] * 6 + [p] * 6
    lib.vse_ctc_greedy_decode.restype = i
    lib.vse_keyframe_stats.argtypes = [p, p] + [i] * 12 + [f, f, p, p, p, p]
    lib.vse_keyframe_stats.restype = i
    return lib


def stream_of(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(t: torch.Tensor):
    """A context that makes ``t``'s device current, or none when it already
    is (a launch goes to the current device)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def check(status: int, kernel: str) -> None:
    """Raise if a launch reported a CUDA error (a refused launch never runs,
    and a later synchronize does not report it)."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA error {status} at launch")
