"""K1: the fused log-mel frontend, [B, L] f32 PCM -> [B, num_mels, L//hop]
log10-mel (no normalization tail).

``fused_log_mel_raw`` is the wrapper of the CUDA kernel in
``csrc/log_mel.cu`` (which replaces the JAX package's
``frontend/pallas_frontend.py::fused_log_mel_raw``; the design note is in
the .cu file). ``log_mel_raw_plain`` is the same function in plain PyTorch
(f32, no TF32); the wrapper takes it only for CPU tensors. The Whisper
clamp tail needs a per-utterance max, so it stays outside the kernel
(``features.normalize_log_mel``), as in the JAX package.
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
_N_CHUNK, _F_TILE = 32, 64  # csrc/log_mel.cu NC and FT


def log_mel_raw_plain(
    wav, n_fft=400, hop=160, num_mels=80, mel_scale="slaney", log_floor=1e-10
):
    """Reflect-padded, hop-framed windowed DFT (a full-f32 matrix product),
    power, mel product, log10(max(., floor)); drops the final frame."""
    pad = n_fft // 2
    x = F.pad(wav.to(torch.float32)[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # [B, L//hop + 1, n_fft]
    basis = torch.from_numpy(_dft_basis(n_fft)).to(wav.device)
    mel = torch.from_numpy(mel_filterbank(num_mels, n_fft, scale=mel_scale)).to(wav.device)
    n_freqs = n_fft // 2 + 1
    with full_f32():
        y = frames[:, :-1] @ basis.T  # [B, T, 2F]
        power = y[..., :n_freqs] ** 2 + y[..., n_freqs:] ** 2
        mel_spec = power @ mel.T  # [B, T, M]
    return torch.log10(torch.clamp(mel_spec, min=log_floor)).transpose(1, 2)


def kernel_basis(n_fft: int, rows: int, f_pad: int) -> np.ndarray:
    """The windowed DFT basis in the log-mel kernels' layout, f32
    [rows, 2 f_pad]: columns [0, n_freqs) window * cos, [f_pad, f_pad +
    n_freqs) -window * sin, zero elsewhere and past n_fft rows."""
    n_freqs = n_fft // 2 + 1
    b = _dft_basis(n_fft)
    basis = np.zeros((rows, 2 * f_pad), np.float32)
    basis[:n_fft, :n_freqs] = b[:n_freqs].T
    basis[:n_fft, f_pad : f_pad + n_freqs] = b[n_freqs:].T
    return basis


@lru_cache(maxsize=8)
def _kernel_constants(n_fft: int, num_mels: int, mel_scale: str, device: str):
    """Basis [n_pad, 2 f_pad] (cos | -sin, zero-padded to the kernel's
    tiles) and mel [num_mels, n_freqs], f32 on `device`."""
    n_pad = -(-n_fft // _N_CHUNK) * _N_CHUNK
    f_pad = -(-(n_fft // 2 + 1) // _F_TILE) * _F_TILE
    mel = mel_filterbank(num_mels, n_fft, scale=mel_scale)
    return (
        torch.from_numpy(kernel_basis(n_fft, n_pad, f_pad)).to(device),
        torch.from_numpy(np.ascontiguousarray(mel)).to(device),
    )


def fused_log_mel_raw(
    wav, n_fft=400, hop=160, num_mels=80, mel_scale="slaney", log_floor=1e-10
):
    """K1 wrapper. CPU tensors take log_mel_raw_plain; a CUDA tensor
    launches the kernel (wav f32 [B, L], L > n_fft // 2) or raises."""
    if wav.device.type == "cpu":
        return log_mel_raw_plain(wav, n_fft, hop, num_mels, mel_scale, log_floor)
    check_cuda("wav", wav, torch.float32, 2)
    B, L = wav.shape
    if L <= n_fft // 2:
        raise ValueError(f"{L} samples: reflect padding needs more than n_fft/2")
    T = L // hop
    basis, mel = _kernel_constants(n_fft, num_mels, mel_scale, str(wav.device))
    out = torch.empty(B, num_mels, T, device=wav.device, dtype=torch.float32)
    launch(
        "jl_log_mel", wav.data_ptr(), basis.data_ptr(), mel.data_ptr(), out.data_ptr(),
        B, L, T, n_fft, hop, n_fft // 2 + 1, num_mels, float(log_floor),
    )
    COUNTER.launches += 1
    return out

