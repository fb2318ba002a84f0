"""Polyphase FIR resampling on the tensor's device (the JAX package's
``frontend/resample.py``): the same Kaiser-windowed sinc (scipy's
``resample_poly`` design), the same output length and phase alignment.

JAX gathers a [B, out_len, taps_per_phase] frame tensor and contracts it
with each output's phase taps: 107 MB of f32 for one 30 s row at 44.1 ->
16 kHz. Here the outputs are taken ``up`` at a time: output ``q * up + r``
reads the input window that starts at ``q * down``, so all ``up`` phases
are one strided ``conv1d`` with ``up`` output channels, whose kernel row
``r`` holds phase ``r``'s taps at that phase's offset inside the window
(zeros elsewhere). The products and the zero padding are JAX's; only the
order of the f32 sum differs.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def f32_conv(device: torch.device):
    """cuDNN convolutions on a card in f32 inside the block (TF32 off, as
    JAX's f32 products), the setting restored after. Nothing changes for
    the CPU, so a host thread never flips the card's setting."""
    if device.type != "cuda":
        yield
        return
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@functools.lru_cache(maxsize=32)
def _design_filter(up: int, down: int, window_beta: float = 5.0,
                   half_width: int = 10) -> np.ndarray:
    """Kaiser-windowed sinc low-pass for rational-rate conversion: beta 5,
    2 * 10 * max(up, down) + 1 taps, cutoff min(1/up, 1/down) of Nyquist,
    gain ``up`` (scipy.signal.resample_poly's default design)."""
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = half_width * max_rate
    t = np.arange(-half_len, half_len + 1, dtype=np.float64)
    h = f_c * np.sinc(f_c * t)
    h *= np.kaiser(2 * half_len + 1, window_beta)
    h *= up
    return h.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _polyphase_kernel(up: int, down: int):
    """-> (kernel [up, 1, L] f32 numpy, base): output q * up + r is
    sum_l kernel[r, 0, l] * x[q * down + base + l] (x zero outside)."""
    h = _design_filter(up, down)
    n_taps = h.shape[0]
    taps_pp = -(-n_taps // up)
    hp = np.pad(h, (0, taps_pp * up - n_taps)).reshape(-1, up).T  # [up, taps_pp]
    half = (n_taps - 1) // 2  # the filter's delay in up-rate samples
    m = np.arange(up) * down + half
    phase, start = m % up, m // up  # y[n] = sum_k hp[phase][k] * x[start - k]
    base = int(start[0]) - (taps_pp - 1)
    L = int(start[-1]) - base + 1
    kernel = np.zeros((up, 1, L), np.float32)
    for r in range(up):
        off = int(start[r]) - base  # l of k = 0
        kernel[r, 0, off - taps_pp + 1:off + 1] = hp[phase[r]][::-1]
    return kernel, base


def resample(x: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """PCM [T] or [B, T] at orig_sr -> [ceil(T * up / down)] or [B, ...] at
    target_sr (up / down = target_sr / orig_sr in lowest terms), on x's
    device, f32 accumulation, x's dtype out. A rate pair that is equal
    returns x."""
    if orig_sr == target_sr:
        return x
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    squeeze = x.dim() == 1
    y = _resample_poly(x[None] if squeeze else x, up, down)
    return y[0] if squeeze else y


def _resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    kernel, base = _polyphase_kernel(up, down)
    B, T = x.shape
    if T == 0:
        return x
    L = kernel.shape[-1]
    out_len = -(-T * up // down)
    Q = -(-out_len // up)  # windows, each giving `up` outputs
    left = max(-base, 0)
    right = max((Q - 1) * down + base + left + L - (left + T), 0)
    xp = F.pad(x.to(torch.float32), (left, right))[:, base + left:]
    w = torch.from_numpy(kernel).to(x.device)
    with f32_conv(x.device):
        y = F.conv1d(xp[:, None, :], w, stride=down)  # [B, up, >= Q]
    y = y[:, :, :Q].transpose(1, 2).reshape(B, Q * up)
    return y[:, :out_len].to(x.dtype)
