"""Waveform augmentation on the waveform's device (the JAX package's
``frontend/augment.py``): random gain, additive noise at a random SNR,
speed perturbation, pitch shift (resample, then a granular overlap-add
stretch back to the length), low / high / band-pass FIR filters with a
cutoff drawn per row, and time stretch. Every transform keeps [B, L].

Each transform is a draw from an explicit ``torch.Generator`` on the
waveform's device and a deterministic core that takes the drawn values
(``apply_gain(wav, gain_db)``, ``apply_noise(wav, snr_db, noise)``,
``apply_speed(wav, rate)``, ``apply_pitch(wav, semitones)``,
``depthwise_filter(wav, taps)``, ``apply_time_stretch(wav, rate)``). The
draws keep JAX's granularity: a transform is applied to the whole batch or
not (one draw), speed, pitch and time stretch pick one rate for the batch,
and gain, SNR, noise and filter cut-offs are drawn per row. The random
bits are torch's, not JAX's: the tests hold the cores to JAX's on the
same values and the draws to JAX's in distribution. Where JAX's
``jnp.where`` / ``lax.switch`` compute every branch, only the branch drawn
is computed here; ``augment_waveform`` reads its batch-level draws to the
host once a call. ``rows`` = (first row, global rows) draws the per-row
values for the global batch and keeps these rows', so a row is augmented
alike whichever process of a data-parallel run holds it (the batch-level
draws are the same on every process).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.config import AugmentConfig
from .resample import f32_conv, resample


def _rows_of(wav: torch.Tensor, rows):
    """-> (first row, global rows) of wav's rows (all of them by default)."""
    return rows or (0, wav.shape[0])


def _uniform(gen: torch.Generator, wav: torch.Tensor, lo: float, hi: float,
             rows=None) -> torch.Tensor:
    """[B, 1] uniform in [lo, hi) on wav's device, as jax.random.uniform's
    minval + u * (maxval - minval)."""
    first, total = _rows_of(wav, rows)
    u = torch.rand((total, 1), generator=gen, device=wav.device)[first:first + wav.shape[0]]
    return lo + u * (hi - lo)


def _pick(gen: torch.Generator, n: int, device) -> int:
    """One index uniform in [0, n) (a host read)."""
    return int(torch.randint(0, n, (), generator=gen, device=device))


# ------------------------------------------------------------ gain and noise


def apply_gain(wav: torch.Tensor, gain_db: torch.Tensor) -> torch.Tensor:
    return wav * 10.0 ** (gain_db / 20.0)


def random_gain(gen, wav: torch.Tensor, lo_db: float, hi_db: float, rows=None) -> torch.Tensor:
    return apply_gain(wav, _uniform(gen, wav, lo_db, hi_db, rows))


def apply_noise(wav: torch.Tensor, snr_db: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """wav + unit `noise` scaled to each row's power over 10^(snr / 10)."""
    sig_pow = torch.mean(wav ** 2, dim=1, keepdim=True) + 1e-12
    noise_pow = sig_pow / 10.0 ** (snr_db / 10.0)
    return wav + noise * torch.sqrt(noise_pow)


def add_noise_snr(gen, wav: torch.Tensor, lo_snr: float, hi_snr: float,
                  rows=None) -> torch.Tensor:
    snr = _uniform(gen, wav, lo_snr, hi_snr, rows)
    first, total = _rows_of(wav, rows)
    noise = torch.randn((total, *wav.shape[1:]), generator=gen, device=wav.device,
                        dtype=wav.dtype)[first:first + wav.shape[0]]
    return apply_noise(wav, snr, noise)


# ------------------------------------------------------ speed, pitch, stretch


def _rate_to_ratio(rate: float, max_den: int = 100) -> Tuple[int, int]:
    fr = Fraction(rate).limit_denominator(max_den)
    return fr.numerator, fr.denominator


def _fix_len(x: torch.Tensor, n: int) -> torch.Tensor:
    """Trim or zero-pad [B, m] to [B, n]."""
    return x[:, :n] if x.shape[1] >= n else F.pad(x, (0, n - x.shape[1]))


def apply_speed(wav: torch.Tensor, rate: float) -> torch.Tensor:
    """Resample by the rate (content 1/rate as long), trimmed or padded
    back to the length."""
    num, den = _rate_to_ratio(rate)
    if num == den:
        return wav
    return _fix_len(resample(wav, num, den), wav.shape[1])


def speed_perturb(gen, wav: torch.Tensor, rates: Sequence[float]) -> torch.Tensor:
    return apply_speed(wav, rates[_pick(gen, len(rates), wav.device)])


def _ola_tables(m: int, n: int, win: int):
    """The OLA stretch's constants: grain starts in the input, the Hann
    window and the summed window at each output sample (f32, JAX's
    scatter-add order: at most two grains overlap at a hop of win / 2)."""
    hop = win // 2
    frames = max((n - win) // hop + 1, 1)
    a_hop = (m - win) / max(frames - 1, 1)
    a_start = np.minimum(np.round(np.arange(frames) * a_hop).astype(np.int64), max(m - win, 0))
    w = (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win) / win))).astype(np.float32)
    wsum = np.zeros(max(n, (frames + 1) * hop), np.float32)
    for f in range(frames):
        wsum[f * hop:f * hop + win] += w
    return a_start, w, wsum[:n], frames


def _ola_stretch_to(y: torch.Tensor, n: int, win: int = 512) -> torch.Tensor:
    """Length-only granular time stretch [B, m] -> [B, n] (phase-free
    overlap-add, augmentation-grade): Hann grains read at an even spread
    over the input, written at a hop of win / 2 and divided by the summed
    window. The overlap is summed as two halves, not scattered, so the
    result is the same on every device."""
    B, m = y.shape
    if m == n:
        return y
    hop = win // 2
    a_start, w, wsum, frames = _ola_tables(m, n, win)
    idx = torch.from_numpy(a_start[:, None] + np.arange(win)[None, :]).to(y.device)
    grains = y[:, idx.clamp(max=m - 1)] * torch.from_numpy(w).to(y.device)  # [B, F, win]
    head = F.pad(grains[:, :, :hop], (0, 0, 0, 1))  # grain f's first half at f * hop
    tail = F.pad(grains[:, :, hop:], (0, 0, 1, 0))  # grain f - 1's second half there
    out = _fix_len((head + tail).reshape(B, (frames + 1) * hop), n)
    return out / torch.from_numpy(np.maximum(wsum, 1e-3)).to(y.device)


def pitch_shifts(lo: float, hi: float) -> list:
    """The whole, non-zero semitone shifts in [lo, hi]."""
    return [s for s in range(math.ceil(lo), math.floor(hi) + 1) if s != 0]


def apply_pitch(wav: torch.Tensor, semitones: int) -> torch.Tensor:
    """Resample by 2^(s/12), which moves pitch and speed, then OLA-stretch
    back to the length, so that only the pitch moves."""
    num, den = _rate_to_ratio(2.0 ** (semitones / 12.0), max_den=64)
    return _ola_stretch_to(resample(wav, num, den), wav.shape[1])


def pitch_shift(gen, wav: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    shifts = pitch_shifts(lo, hi)
    if not shifts:
        return wav
    return apply_pitch(wav, shifts[_pick(gen, len(shifts), wav.device)])


def apply_time_stretch(wav: torch.Tensor, rate: float) -> torch.Tensor:
    """OLA-stretch the content to length n / rate (pitch kept), then trim
    or pad back to n."""
    if abs(rate - 1.0) < 1e-9:
        return wav
    n = wav.shape[1]
    return _fix_len(_ola_stretch_to(wav, max(int(round(n / rate)), 2)), n)


def time_stretch(gen, wav: torch.Tensor, rates: Sequence[float]) -> torch.Tensor:
    return apply_time_stretch(wav, float(rates[_pick(gen, len(rates), wav.device)]))


# ------------------------------------------------------------------ filters


def lowpass_fir_taps(fc: torch.Tensor, taps: int) -> torch.Tensor:
    """Hann-windowed sinc low-pass taps [..., taps] for a normalized cutoff
    fc in (0, 0.5) cycles a sample ([B, 1] gives [B, taps]); unity DC gain."""
    n = torch.arange(taps, dtype=torch.float32, device=fc.device) - (taps - 1) / 2.0
    h = 2.0 * fc * torch.sinc(2.0 * fc * n)
    k = torch.arange(taps, dtype=torch.float32, device=fc.device)
    h = h * (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / (taps - 1)))
    return h / torch.sum(h, dim=-1, keepdim=True)


def highpass_fir_taps(fc: torch.Tensor, taps: int) -> torch.Tensor:
    """Spectral inversion of the low-pass: delta - lowpass (taps odd)."""
    h = -lowpass_fir_taps(fc, taps)
    center = torch.zeros(taps, dtype=torch.float32, device=fc.device)
    center[(taps - 1) // 2] = 1.0
    return h + center


def bandpass_fir_taps(f_lo: torch.Tensor, f_hi: torch.Tensor, taps: int) -> torch.Tensor:
    """lowpass(f_hi) - lowpass(f_lo) passes (f_lo, f_hi)."""
    return lowpass_fir_taps(f_hi, taps) - lowpass_fir_taps(f_lo, taps)


def depthwise_filter(wav: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """A FIR per row: wav [B, L], kernels [B, K] -> [B, L] ('same'
    alignment, K // 2 zeros before and K - 1 - K // 2 after); one grouped
    conv1d, f32 products. The taps are symmetric, so conv1d's
    cross-correlation is the convolution."""
    B, _ = wav.shape
    K = kernels.shape[-1]
    x = F.pad(wav.to(torch.float32)[None], (K // 2, K - 1 - K // 2))
    with f32_conv(wav.device):
        y = F.conv1d(x, kernels.to(torch.float32)[:, None, :], groups=B)
    return y[0].to(wav.dtype)


def random_lowpass(gen, wav, hz_range: Tuple[float, float], sr: int, taps: int, rows=None):
    fc = _uniform(gen, wav, hz_range[0] / sr, hz_range[1] / sr, rows)
    return depthwise_filter(wav, lowpass_fir_taps(fc, taps))


def random_highpass(gen, wav, hz_range: Tuple[float, float], sr: int, taps: int, rows=None):
    fc = _uniform(gen, wav, hz_range[0] / sr, hz_range[1] / sr, rows)
    return depthwise_filter(wav, highpass_fir_taps(fc, taps))


def random_bandpass(gen, wav, lo_range: Tuple[float, float], hi_range: Tuple[float, float],
                    sr: int, taps: int, rows=None):
    f_lo = _uniform(gen, wav, lo_range[0] / sr, lo_range[1] / sr, rows)
    f_hi = _uniform(gen, wav, hi_range[0] / sr, hi_range[1] / sr, rows)
    return depthwise_filter(wav, bandpass_fir_taps(f_lo, f_hi, taps))


# -------------------------------------------------------------------- chain


def augment_waveform(gen: torch.Generator, wav: torch.Tensor, cfg: AugmentConfig,
                     sample_rate: int = 16000, rows=None) -> torch.Tensor:
    """The augmentation chain over [B, L] PCM (shape kept), in JAX's order:
    gain, noise, speed, pitch, low-pass, high-pass, band-pass, time
    stretch. `gen` is a generator on wav's device. The eight gates and the
    three rate picks are drawn first, in one draw read to the host; the
    per-row values are drawn only by the transforms that run."""
    if not cfg.enabled:
        return wav
    u = torch.rand(11, generator=gen, device=wav.device).tolist()

    def pick(i: int, n: int) -> int:
        return min(int(u[8 + i] * n), n - 1)

    p = cfg.probability
    if u[0] < p:
        wav = random_gain(gen, wav, *cfg.gain_db, rows)
    if u[1] < p:
        wav = add_noise_snr(gen, wav, *cfg.noise_snr_db, rows)
    if len(cfg.speed_rates) > 1 and u[2] < p:
        wav = apply_speed(wav, cfg.speed_rates[pick(0, len(cfg.speed_rates))])
    shifts = pitch_shifts(*cfg.pitch_semitones)
    if shifts and u[3] < p:
        wav = apply_pitch(wav, shifts[pick(1, len(shifts))])
    if u[4] < cfg.lowpass_probability:
        wav = random_lowpass(gen, wav, cfg.lowpass_hz, sample_rate, cfg.filter_taps, rows)
    if u[5] < cfg.highpass_probability:
        wav = random_highpass(gen, wav, cfg.highpass_hz, sample_rate, cfg.filter_taps, rows)
    if u[6] < cfg.bandpass_probability:
        wav = random_bandpass(gen, wav, cfg.highpass_hz, cfg.lowpass_hz, sample_rate,
                              cfg.filter_taps, rows)
    rates = cfg.time_stretch_rates
    if len(rates) > 0 and u[7] < p:
        wav = apply_time_stretch(wav, float(rates[pick(2, len(rates))]))
    return wav
