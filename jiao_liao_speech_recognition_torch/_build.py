"""Builds the port's CUDA kernels at first use and binds them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``
(all started together), and the objects are linked into one shared library
with a plain C interface. The library is named after a hash
of the sources and flags and lives in ``_build/`` beside this file, so an
edited source rebuilds and an unchanged one loads at once; ptxas's report
of every kernel's registers and spills is kept beside it (``ptxas_report``).
A file lock keeps concurrent processes from building the same library
twice.

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
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

SMEM_LIMIT = 232448  # shared memory one block may opt into on the H100 (227 KB)

P = ctypes.c_void_p  # device pointer or stream
I = ctypes.c_int
L = ctypes.c_longlong  # element strides
F = ctypes.c_float

# exported C functions and their argument types (pointers, ints, strides,
# floats, and the stream last)
SIGNATURES = {
    "jl_log_mel": [P, P, P, P, P, P, I, I, I, I, I, I, I, F, P],
    "jl_ln_qkv": [P, P, P, P, P, P, P, I, I, I, F, P],
    "jl_attention_core": [P, P, P, I, I, I, I, F, P],
    "jl_attn_out_proj": [P, P, P, P, P, I, I, P],
    "jl_out_proj_residual": [P, P, P, P, P, I, I, P],
    "jl_ln_mlp_residual": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, P],
    "jl_gelu_check": [P, P, I, P],
    "jl_gemm": [I, P, P, P, P, P, I, I, I, P],
    "jl_row_partial": [P, P, P, I, I, I, P],
    "jl_ln_fc1": [P, P, P, P, P, P, P, I, I, I, I, F, P],
    "jl_head_argmax": [P, P, P, P, P, I, I, I, I, P],
    "jl_flash_fwd": [P, L, L, P, L, L, P, L, L, P, P, P, I, I, I, I, I, I, F, P],
    "jl_flash_bwd": [P, L, L, P, L, L, P, L, L, P, P, P, P, P, P, P, P,
                     I, I, I, I, I, I, F, P],
    "jl_decode_attention": [P, P, P, P, P, I, I, I, I, I, F, P],
    "jl_decode_attention_int8": [P, P, P, P, P, P, P, I, I, I, I, I, F, P],
    "jl_int8_matmul": [P, P, P, P, P, I, I, I, P],
    "jl_int8_row_partial": [P, P, P, P, I, I, I, P],
    "jl_int8_tied_logits": [P, P, P, P, I, I, I, P],
    "jl_int8_tied_logits_ragged": [P, P, P, P, I, I, I, P],
    "jl_int8_kv_write": [P, P, L, L, P, P, P, P, P, I, I, I, I, I, P],
    "jl_ctc_loss_fwd": [P, P, P, P, P, P, P, I, I, I, I, I, P],
    "jl_ctc_loss_bwd": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P],
    # the A/B probes of examples/ (ops/probes.py)
    "jl_w8a8_ln_mlp_residual": [P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, P],
    "jl_log_mel_bf16x3": [P, P, P, P, P, P, I, I, I, I, I, I, I, F, P],
    "jl_head_argmax_chunked": [P, P, P, P, I, I, I, I, P],
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
            objs = []
            procs = []
            for src in (s for s in _sources() if s.suffix == ".cu"):
                obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
                objs.append(str(obj))
                cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(src)]
                procs.append((src.name, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            report = []
            for name, proc in procs:
                out, err = proc.communicate()
                _check_nvcc(name, proc.returncode, out, err)
                report.append(out + err)
            so.with_suffix(".ptxas.txt").write_text("".join(report))
            link = [_nvcc(), "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *objs]
            r = subprocess.run(link, capture_output=True, text=True)
            _check_nvcc("link", r.returncode, r.stdout, r.stderr)
            os.replace(tmp, so)
            for obj in objs:
                os.remove(obj)
    return so, time.perf_counter() - t0


def ptxas_report() -> dict:
    """-> {kernel symbol: (registers, spill store bytes, spill load bytes)}
    from ptxas's report on the library as built (empty if it was built
    without one)."""
    path = library_path().with_suffix(".ptxas.txt")
    if not path.exists():
        return {}
    kernels, name = {}, None
    for line in path.read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            kernels[name] = [0, int(m.group(1)), int(m.group(2))]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name in kernels:
            kernels[name][0] = int(m.group(1))
            name = None
    return {k: tuple(v) for k, v in kernels.items()}


def _check_nvcc(what: str, rc: int, out: str, err: str) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed on {what} (rc={rc}):\n{out}\n{err}")


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


def check_aligned(name: str, *tensors) -> None:
    """Raise unless every tensor's data starts on a 16-byte boundary, as the
    tensor maps and the 16-byte vector loads of the TMA kernels need."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: an operand is not 16-byte aligned")


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through a kernel that has no
    backward (a CUDA result would silently carry none)."""
    import torch

    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under torch.no_grad() "
            "or take the module path"
        )


COUNTERS: list = []  # every LaunchCounter made, in order


class LaunchCounter:
    """Plain count of kernel launches made by one wrapper (listed in
    ``COUNTERS``)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        COUNTERS.append(self)

    def reset(self) -> None:
        self.launches = 0
