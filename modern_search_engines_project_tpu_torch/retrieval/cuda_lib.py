"""Build, load and launch the port's hand-written CUDA kernels.

The sources are ``csrc/*.cu``, each with plain ``extern "C"`` launchers
(pointers, sizes and a ``cudaStream_t`` in; ``cudaGetLastError()`` out).
At first use ONE ``nvcc`` call compiles them all for ``sm_90a`` into one
shared library, bound with ``ctypes``; no PyTorch header is compiled, so
the build takes seconds.  The library lands in
``<checkout>/build/torch_kernels/<hash of sources and flags>/`` — a fresh
checkout builds it on its first kernel launch.

Nothing here runs at import time: the CPU has no ``nvcc`` and never
reaches a launch (the wrappers take their plain PyTorch versions for CPU
tensors).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
LIB_NAME = "libmse_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills into build.log
)

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# launcher symbol -> argtypes (the trailing _P is the stream)
SIGNATURES = {
    "mse_bm25_slots": [_P, _P, _P, _P, _I32, _P, _P, _I32, _I32, _P, _I64, _P],
    "mse_bm25_slots_udedup_bf16": [
        _P, _P, _P, _P, _I32, _P, _I32, _P, _I32, _P, _I64, _P,
    ],
    "mse_bm25_slots_udedup_i8": [
        _P, _P, _P, _P, _I32, _P, _I32, _P, _I32, _P, _I64, _P,
    ],
    "mse_dense_stats": [
        _P, _P, _I32, _I32, _I32, _I32, _P, _P, _P, _P, _P, _P,
    ],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists.
    Concurrent builders each write a private file and rename it into
    place, so a reader never sees a partial library."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{os.getpid()}.{LIB_NAME}")
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (so.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    return so


def build_log() -> str:
    log = library_path().parent / "build.log"
    return log.read_text() if log.exists() else ""


def load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.mse_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mse_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


class CudaKernel:
    """One launcher of the library plus its launch count.

    ``launches`` grows by one for every launch this object makes, and
    nowhere else; plain-version calls never touch it."""

    def __init__(self, name: str, symbol: str, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.source = source  # path in the repo
        self.replaces = replaces  # file:line of the TPU kernel
        self.launches = 0

    def launch(self, device: torch.device, *args) -> None:
        lib = load()
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = getattr(lib, self.symbol)(*args, stream)
        if rc != 0:
            msg = lib.mse_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: launch failed: {msg} ({rc})")
        self.launches += 1


KERNELS: list = []  # every CudaKernel of the port, in registration order


def register(kernel: CudaKernel) -> CudaKernel:
    KERNELS.append(kernel)
    return kernel


def check(t: torch.Tensor, name: str, dtype, device, ndim: int) -> None:
    """Raise unless ``t`` is what a launcher takes."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
