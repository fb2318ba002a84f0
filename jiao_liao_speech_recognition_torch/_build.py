"""Builds the port's CUDA kernels at first use and binds them with ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface. The library is named after a hash
of the sources and flags and lives in ``_build/`` beside this file, so an
edited source rebuilds and an unchanged one loads at once. A file lock
keeps concurrent processes from building the same library twice.

Each exported function takes device pointers and the CUDA stream as
``c_void_p``, launches on that stream and returns ``cudaGetLastError()``;
``launch`` raises when that is not 0. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

P = ctypes.c_void_p  # device pointer or stream
I = ctypes.c_int
F = ctypes.c_float

# exported C functions and their argument types (pointers, ints, floats,
# and the stream last)
SIGNATURES = {
    "jl_log_mel": [P, P, P, P, I, I, I, I, I, I, I, F, P],
    "jl_ln_qkv": [P, P, P, P, P, P, I, I, I, F, P],
    "jl_attention_out": [P, P, P, P, P, P, I, I, I, I, P],
    "jl_ln_mlp_residual": [P, P, P, P, P, P, P, P, I, I, I, I, F, P],
    "jl_head_argmax": [P, P, P, P, I, I, I, I, P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libjl_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is missing -> (path, seconds spent)."""
    so = library_path()
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            tmp = so.with_suffix(f".tmp{os.getpid()}")
            cus = [str(s) for s in _sources() if s.suffix == ".cu"]
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *cus]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (rc={r.returncode}):\n{r.stdout}\n{r.stderr}"
                )
            os.replace(tmp, so)
    return so, time.perf_counter() - t0


@functools.cache
def _library() -> ctypes.CDLL:
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call exported kernel `name` on the current stream; raise on a launch
    error. Pointer arguments are ints (``tensor.data_ptr()``)."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(_library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_cuda(name: str, t, dtype, ndim: int) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` and `ndim` dims."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


class LaunchCounter:
    """Plain count of kernel launches made by one wrapper."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def reset(self) -> None:
        self.launches = 0
