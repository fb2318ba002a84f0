"""K1: the fused log-mel frontend, [B, L] f32 PCM -> [B, num_mels, L//hop]
log10-mel (no normalization tail).

``fused_log_mel_raw`` is the wrapper of the CUDA kernel in
``csrc/log_mel_tf32.cu`` (which replaces the JAX package's
``frontend/pallas_frontend.py::fused_log_mel_raw``; the design note is in
the .cu file): the DFT as 3xTF32 tensor-core products, the power, the mel
product and the log in one launch. ``log_mel_raw_plain`` is the same
function in plain PyTorch (f32, no TF32); the wrapper takes it only for CPU
tensors. The Whisper clamp tail needs a per-utterance max, so it stays
outside the kernel (``features.normalize_log_mel``), as in the JAX package.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .._build import LaunchCounter, check_cuda, launch
from ..ops.numerics import full_f32
from .features import _dft_basis, mel_filterbank

COUNTER = LaunchCounter("fused_log_mel_raw")
# csrc/log_mel_tf32.cu: the basis is [BASIS_N][BASIS_K] (columns of the DFT x
# its k), 8-frequency groups of cos then sin columns; a 16-wide k step never
# crosses a hop row; the staged rows fit one block's shared memory up to
# MAX_HOP at n_fft 400
BASIS_N, BASIS_K, FREQ_GROUP, K_STEP, MAX_HOP = 416, 416, 8, 16, 160


def mel_power(wav, n_fft=400, hop=160, num_mels=80, mel_scale="slaney", sample_rate=16000):
    """Reflect-padded, hop-framed windowed DFT (a full-f32 matrix product),
    power, mel product -> [B, L//hop, num_mels]; drops the final frame."""
    pad = n_fft // 2
    x = F.pad(wav.to(torch.float32)[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # [B, L//hop + 1, n_fft]
    basis = torch.from_numpy(_dft_basis(n_fft)).to(wav.device)
    mel = torch.from_numpy(mel_filterbank(num_mels, n_fft, sample_rate, scale=mel_scale))
    n_freqs = n_fft // 2 + 1
    with full_f32():
        y = frames[:, :-1] @ basis.T  # [B, T, 2F]
        power = y[..., :n_freqs] ** 2 + y[..., n_freqs:] ** 2
        return power @ mel.to(wav.device).T


def log_mel_raw_plain(
    wav, n_fft=400, hop=160, num_mels=80, mel_scale="slaney", log_floor=1e-10
):
    """mel_power, then log10(max(., floor)) -> [B, num_mels, L//hop]."""
    mel_spec = mel_power(wav, n_fft, hop, num_mels, mel_scale)
    return torch.log10(torch.clamp(mel_spec, min=log_floor)).transpose(1, 2)


def tf32_round(a: np.ndarray) -> np.ndarray:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from zero:
    cvt.rna.tf32.f32, as f32 with the low 13 bits clear."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_split(a: np.ndarray):
    """-> (hi, lo): hi = tf32(a), lo = tf32(a - hi), the 3xTF32 operands."""
    hi = tf32_round(a)
    return hi, tf32_round(np.asarray(a, np.float32) - hi)


def bf16_split(a: np.ndarray):
    """-> (hi, lo) as bf16 tensors: hi = bf16(a), lo = bf16(a - hi), each
    rounded to nearest even (cvt.rn.bf16.f32): the bf16x3 operands of P1
    (ops/probes.py), which reads K1's basis layout split this way."""
    full = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    hi = full.to(torch.bfloat16)
    return hi, (full - hi.float()).to(torch.bfloat16)


def tf32_basis(n_fft: int) -> np.ndarray:
    """The windowed DFT basis in K1's layout, f32 [BASIS_N, BASIS_K]: row
    16 q + e (e < 8) is window * cos of frequency 8 q + e over k, row
    16 q + 8 + e its -window * sin; zero past n_fft and n_freqs."""
    n_freqs = n_fft // 2 + 1
    b = _dft_basis(n_fft)  # [2 n_freqs, n_fft]: cos rows, then -sin rows
    basis = np.zeros((BASIS_N, BASIS_K), np.float32)
    for f in range(n_freqs):
        q, e = divmod(f, FREQ_GROUP)
        basis[2 * FREQ_GROUP * q + e, :n_fft] = b[f]
        basis[2 * FREQ_GROUP * q + FREQ_GROUP + e, :n_fft] = b[n_freqs + f]
    return basis


def mel_bands(mel: np.ndarray) -> np.ndarray:
    """[num_mels, 2] i32: each filter's first and one-past-last nonzero
    column (0, 0 for an all-zero filter)."""
    bands = np.zeros((mel.shape[0], 2), np.int32)
    for m, row in enumerate(mel):
        nz = np.flatnonzero(row)
        if nz.size:
            bands[m] = nz[0], nz[-1] + 1
    return bands


@lru_cache(maxsize=8)
def _kernel_constants(n_fft: int, num_mels: int, mel_scale: str, device: str):
    """(basis hi, basis lo) [BASIS_N, BASIS_K] (tf32_basis split by
    tf32_split), mel [num_mels, n_freqs] f32 and its bands [num_mels, 2]
    i32, on `device`."""
    mel = np.ascontiguousarray(mel_filterbank(num_mels, n_fft, scale=mel_scale))
    hi, lo = tf32_split(tf32_basis(n_fft))
    return tuple(torch.from_numpy(a).to(device) for a in (hi, lo, mel, mel_bands(mel)))


def fused_log_mel_raw(
    wav, n_fft=400, hop=160, num_mels=80, mel_scale="slaney", log_floor=1e-10
):
    """K1 wrapper. CPU tensors take log_mel_raw_plain; a CUDA tensor
    launches the kernel (wav f32 [B, L], L > n_fft // 2; hop % 16 == 0,
    hop <= MAX_HOP, n_fft <= BASIS_K and n_fft // 2 + 1 <= BASIS_N / 2) or
    raises."""
    if wav.device.type == "cpu":
        return log_mel_raw_plain(wav, n_fft, hop, num_mels, mel_scale, log_floor)
    check_cuda("wav", wav, torch.float32, 2)
    B, L = wav.shape
    n_freqs = n_fft // 2 + 1
    if L <= n_fft // 2:
        raise ValueError(f"{L} samples: reflect padding needs more than n_fft/2")
    if hop % K_STEP or hop > MAX_HOP or n_fft > BASIS_K or 2 * n_freqs > BASIS_N:
        raise ValueError(f"unsupported log-mel shape: n_fft={n_fft} hop={hop}")
    T = L // hop
    hi, lo, mel, bands = _kernel_constants(n_fft, num_mels, mel_scale, str(wav.device))
    out = torch.empty(B, num_mels, T, device=wav.device, dtype=torch.float32)
    launch(
        "jl_log_mel", wav.data_ptr(), hi.data_ptr(), lo.data_ptr(), mel.data_ptr(),
        bands.data_ptr(), out.data_ptr(), B, L, T, n_fft, hop, n_freqs, num_mels,
        float(log_floor),
    )
    COUNTER.launches += 1
    return out
