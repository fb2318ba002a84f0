"""The port's ctypes bindings of the C++ host libraries the JAX package's
``utils/native_ext.py`` loads (a copy: that module sits in a package that
imports jax): the CTC prefix beam search (``native/beam.cpp``), the WAV
decoder (``native/wavio.cpp``) and the FLAC decoder (``native/flacio.cpp``).

``load_beam()`` / ``load_wavio()`` / ``load_flacio()`` build their library
at first use with the flags of ``native/Makefile`` into the port's
``_build/`` directory, named after a hash of the source, the flags and the
compiler's resolved target (so a tree copied to a machine with another CPU
rebuilds instead of loading code for the wrong one), under the file lock
``_build.py`` uses for the CUDA library. A failed build raises with the
compiler's output; what falls back is the caller's choice
(``frontend/audio_io.read_wav`` falls back to the stdlib decoder, the beam
and FLAC do not). Edit distance and BPE are not bound here.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .._build import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall", "-pthread")
SOURCES = {"beam": "beam.cpp", "wavio": "wavio.cpp", "flacio": "flacio.cpp"}


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) on the PATH: native/*.cpp cannot be built")
    return cxx


@functools.cache
def _target(cxx: str) -> str:
    """The compiler's options as -march=native resolves them on this machine."""
    r = subprocess.run([cxx, "-march=native", "-Q", "--help=target"], capture_output=True,
                       text=True)
    return r.stdout


def library_path(name: str) -> Path:
    src = NATIVE_DIR / SOURCES[name]
    cxx = _cxx()
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join((cxx, *CXX_FLAGS)).encode())
    h.update(_target(cxx).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def native_available(name: str) -> bool:
    """Whether library `name` is built for the current source and machine."""
    try:
        return library_path(name).exists()
    except RuntimeError:
        return False


def build_native(name: str = "beam") -> Path:
    """Compile library `name` if it is missing -> its path; raises with the
    compiler's output when the build fails."""
    so = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            tmp = so.with_suffix(f".tmp{os.getpid()}")
            cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / SOURCES[name])]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed (rc={r.returncode}):\n"
                                   f"{r.stdout}\n{r.stderr}")
            os.replace(tmp, so)
    return so


class Beam:
    """``search(lp_top, tok_top, lp_blank, lengths, beam_size, n_threads=0,
    prune_logp=0.0) -> (ids [B, T] int32, lens [B] int32)`` over the
    device-pruned top-k frame posteriors (decode/ctc.py::
    ctc_prefix_beam_search_native); inputs are widened to f32 / int32."""

    def __init__(self, lib: ctypes.CDLL):
        fn = lib.ctc_beam_search_topk
        fn.restype = None
        f32, i32 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
        fn.argtypes = [
            f32,             # lp_top [B, T, K]
            i32,             # tok_top [B, T, K]
            f32,             # lp_blank [B, T]
            i32,             # lengths [B]
            ctypes.c_int32,  # B
            ctypes.c_int32,  # T
            ctypes.c_int32,  # K
            ctypes.c_int32,  # beam_size
            i32,             # out_ids [B, T]
            i32,             # out_lens [B]
            ctypes.c_int32,  # n_threads (<= 0: the hardware's)
            ctypes.c_float,  # prune_logp (< 0 prunes; >= 0 exact)
        ]
        self._fn = fn

    def search(self, lp_top, tok_top, lp_blank, lengths, beam_size: int, n_threads: int = 0,
               prune_logp: float = 0.0):
        lp_top = np.ascontiguousarray(lp_top, dtype=np.float32)
        tok_top = np.ascontiguousarray(tok_top, dtype=np.int32)
        lp_blank = np.ascontiguousarray(lp_blank, dtype=np.float32)
        lengths = np.ascontiguousarray(lengths, dtype=np.int32)
        B, T, K = lp_top.shape
        if tok_top.shape != (B, T, K) or lp_blank.shape != (B, T) or lengths.shape != (B,):
            raise ValueError(f"beam search: shapes {lp_top.shape}, {tok_top.shape}, "
                             f"{lp_blank.shape}, {lengths.shape} are not [B, T, K] x 2, "
                             "[B, T], [B]")
        out_ids = np.zeros((B, T), dtype=np.int32)
        out_lens = np.zeros((B,), dtype=np.int32)

        def ptr(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        f32, i32 = ctypes.c_float, ctypes.c_int32
        self._fn(ptr(lp_top, f32), ptr(tok_top, i32), ptr(lp_blank, f32), ptr(lengths, i32),
                 B, T, K, beam_size, ptr(out_ids, i32), ptr(out_lens, i32), n_threads,
                 float(prune_logp))
        return out_ids, out_lens


@functools.cache
def load_beam() -> Beam:
    """The C++ batched CTC prefix beam search, built at first use."""
    return Beam(ctypes.CDLL(str(build_native("beam"))))


class WavIO:
    """``read(path) -> (mono float32 PCM, sample_rate)``: 8/16/24/32-bit
    PCM and 32/64-bit IEEE float WAV, channels averaged in f64."""

    def __init__(self, lib: ctypes.CDLL):
        self._info, self._read = lib.jl_wav_info, lib.jl_wav_read
        self._info.restype = self._read.restype = ctypes.c_int32
        i64p, i32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
        self._info.argtypes = [ctypes.c_char_p, i64p, i32p, i32p]  # frames, rate, channels
        self._read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]

    def read(self, path: str):
        frames, sr, ch = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
        rc = self._info(str(path).encode(), ctypes.byref(frames), ctypes.byref(sr),
                        ctypes.byref(ch))
        if rc != 0:
            raise IOError(f"wavio: cannot read header of {path} (rc={rc})")
        out = np.empty(frames.value, dtype=np.float32)
        rc = self._read(str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        frames.value)
        if rc != 0:
            raise IOError(f"wavio: decode failed for {path} (rc={rc})")
        return out, sr.value


# a frame count above this in a (untrusted) STREAMINFO header is refused
# rather than allocated: ~17 h at 16 kHz
MAX_FLAC_FRAMES = 1_000_000_000


class FlacIO:
    """``info(path) -> (frames, sample_rate, channels)``;
    ``read(path) -> (mono float32 PCM, sample_rate)``."""

    def __init__(self, lib: ctypes.CDLL):
        self._info, self._read = lib.jl_flac_info, lib.jl_flac_read
        self._info.restype = self._read.restype = ctypes.c_int32
        i64p, i32p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)
        self._info.argtypes = [ctypes.c_char_p, i64p, i32p, i32p]
        self._read.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                               i64p]  # decoded frames

    def info(self, path: str):
        frames, sr, ch = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
        rc = self._info(str(path).encode(), ctypes.byref(frames), ctypes.byref(sr),
                        ctypes.byref(ch))
        if rc != 0:
            raise IOError(f"flacio: cannot read header of {path} (rc={rc})")
        return frames.value, sr.value, ch.value

    def read(self, path: str):
        frames, sr, _ = self.info(path)
        if frames > MAX_FLAC_FRAMES:
            raise IOError(f"flacio: implausible frame count {frames} in {path}")
        out = np.empty(max(frames, 1), dtype=np.float32)
        decoded = ctypes.c_int64()
        rc = self._read(str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        frames, ctypes.byref(decoded))
        if rc != 0:
            raise IOError(f"flacio: decode failed for {path} (rc={rc})")
        return out[:decoded.value], sr


@functools.cache
def load_wavio() -> WavIO:
    """The C++ WAV decoder, built at first use."""
    return WavIO(ctypes.CDLL(str(build_native("wavio"))))


@functools.cache
def load_flacio() -> FlacIO:
    """The C++ FLAC decoder, built at first use."""
    return FlacIO(ctypes.CDLL(str(build_native("flacio"))))
