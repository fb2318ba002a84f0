"""Whisper-style log-mel features, the PyTorch twin of the JAX package's
``frontend/features.py``.

Pipeline: pad/trim to 30 s -> centered (reflect-padded) STFT with
n_fft=400, hop=160 and a periodic Hann window, written as a DFT matrix
product -> power -> slaney mel filterbank -> log10 with a 1e-10 floor ->
clamp to (per-utterance max - 8) -> (x + 4) / 4. All frontend math is f32.

``fbank`` is the recipe family's SpeechBrain-style variant (preemphasis,
natural log, utterance CMVN), plain PyTorch as in the JAX package.
``_dft_basis`` and ``mel_filterbank`` are numpy twins of the JAX module's
(which cannot be imported without jax); the tests pin them equal.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from ..ops.numerics import full_f32
from ..utils.config import FrontendConfig


def _hz_to_mel(f, scale: str) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):  # f=0 hits the unused log branch
        return np.where(
            f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mels
        )


def _mel_to_hz(m, scale: str) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=16)
def mel_filterbank(
    num_mels: int = 80,
    n_fft: int = 400,
    sample_rate: int = 16000,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    scale: str = "slaney",
    norm: Optional[str] = "slaney",
) -> np.ndarray:
    """Triangular mel filterbank [num_mels, n_fft//2 + 1] (float32),
    librosa / transformers compatible for the Whisper configuration."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(fmin, scale), _hz_to_mel(fmax, scale), num_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, scale)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2 : num_mels + 2] - hz_pts[:num_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


@lru_cache(maxsize=8)
def _dft_basis(n_fft: int) -> np.ndarray:
    """[2 * (n_fft//2+1), n_fft] stacked (cos; -sin) basis with the periodic
    Hann window folded in. Power spectrum = (x@cos.T)^2 + (x@sin.T)^2."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))
    k = np.arange(n_freqs, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * k * n[None, :] / n_fft
    basis = np.concatenate([np.cos(ang), -np.sin(ang)], axis=0) * window[None, :]
    return basis.astype(np.float32)


def stft_power(wav: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Centered power STFT of [B, L] -> [B, n_freqs, 1 + L // hop_length] f32:
    reflect-padded by n_fft // 2 on both sides (torch / librosa
    ``center=True``), the windowed DFT as one full-f32 product over the hop
    frames (the JAX function's HIGHEST-precision convolution)."""
    pad = n_fft // 2
    x = torch.nn.functional.pad(wav.to(torch.float32)[:, None, :], (pad, pad),
                                mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop_length)  # [B, 1 + L // hop, n_fft]
    basis = torch.from_numpy(_dft_basis(n_fft)).to(wav.device)
    n_freqs = n_fft // 2 + 1
    with full_f32():
        y = (frames @ basis.T).transpose(1, 2)  # [B, 2 n_freqs, T]
    return y[:, :n_freqs] ** 2 + y[:, n_freqs:] ** 2


def pad_or_trim(wav: np.ndarray, cfg: FrontendConfig) -> np.ndarray:
    """Host-side pad/trim of 1-D PCM to the fixed chunk (30 s)."""
    target = int(cfg.chunk_seconds * cfg.sample_rate)
    if len(wav) >= target:
        return np.asarray(wav[:target], dtype=np.float32)
    out = np.zeros(target, dtype=np.float32)
    out[: len(wav)] = wav
    return out


def dequantize_pcm(wav: torch.Tensor) -> torch.Tensor:
    """int16 wire-format audio -> float32 in [-1, 1) (exact: x / 2^15);
    float input passes through untouched."""
    if wav.dtype == torch.int16:
        return wav.to(torch.float32) * (1.0 / 32768.0)
    return wav


def normalize_log_mel(log_spec: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """The tail after log10: Whisper clamp to (utterance max - 8) and
    (x + 4) / 4, then utterance CMVN if configured. [B, M, T] f32."""
    if cfg.whisper_norm:
        mx = log_spec.amax(dim=(1, 2), keepdim=True)
        log_spec = torch.maximum(log_spec, mx - 8.0)
        log_spec = (log_spec + 4.0) / 4.0
    if cfg.cmvn == "utterance":
        mean = log_spec.mean(dim=2, keepdim=True)
        std = log_spec.std(dim=2, keepdim=True, unbiased=False)
        log_spec = (log_spec - mean) / (std + 1e-8)
    return log_spec


def log_mel_spectrogram(
    wav: torch.Tensor, cfg: Optional[FrontendConfig] = None
) -> torch.Tensor:
    """[B, L] (or [L]) float32 PCM -> [B, num_mels, L//hop] normalized
    log-mel, plain PyTorch (the reference the K1 kernel is held against)."""
    from .fused_frontend import log_mel_raw_plain

    cfg = cfg or FrontendConfig()
    if wav.dim() == 1:
        wav = wav[None, :]
    raw = log_mel_raw_plain(
        wav, cfg.n_fft, cfg.hop_length, cfg.num_mels, cfg.mel_scale, cfg.log_floor
    )
    return normalize_log_mel(raw, cfg)


def fbank(wav: torch.Tensor, cfg: Optional[FrontendConfig] = None) -> torch.Tensor:
    """SpeechBrain-style log-mel fbank: optional preemphasis -> centered
    power STFT -> mel -> natural log with cfg.log_floor -> optional
    utterance CMVN; [B, L] (or [L]) f32 PCM -> [B, num_mels, L//hop]. Plain
    full-f32 PyTorch, as the JAX function is plain XLA at HIGHEST
    precision: no kernel. The default config is the recipe family's
    (no Whisper tail, utterance CMVN, preemphasis 0.97)."""
    from .fused_frontend import mel_power

    cfg = cfg or FrontendConfig(whisper_norm=False, cmvn="utterance", preemphasis=0.97)
    if wav.dim() == 1:
        wav = wav[None, :]
    x = wav.to(torch.float32)
    if cfg.preemphasis > 0:
        x = torch.cat([x[:, :1], x[:, 1:] - cfg.preemphasis * x[:, :-1]], dim=1)
    mel_spec = mel_power(x, cfg.n_fft, cfg.hop_length, cfg.num_mels, cfg.mel_scale,
                         cfg.sample_rate)
    log_spec = torch.log(torch.clamp(mel_spec, min=cfg.log_floor)).transpose(1, 2)
    if cfg.cmvn == "utterance":
        mean = log_spec.mean(dim=2, keepdim=True)
        std = log_spec.std(dim=2, keepdim=True, unbiased=False)
        log_spec = (log_spec - mean) / (std + 1e-8)
    return log_spec


BATCH_LOG_FLOOR = 1e-10  # featurize_batch's floor: FrontendConfig's default


def featurize_batch(
    wav: torch.Tensor, cfg: Optional[FrontendConfig] = None, kernels: bool = True
) -> torch.Tensor:
    """Padded batch [B, chunk_samples] (f32 or int16) -> [B, mels, frames].

    kernels=True runs the K1 wrapper (the CUDA kernel for a CUDA tensor, its
    plain version for a CPU tensor); kernels=False runs the plain version on
    any device. cmvn="global" applies corpus stats from cfg.cmvn_stats_path.
    """
    from .fused_frontend import fused_log_mel_raw, log_mel_raw_plain

    cfg = cfg or FrontendConfig()
    if cfg.cmvn not in ("none", "utterance", "global"):
        raise ValueError(f"unknown cmvn mode {cfg.cmvn!r}")
    wav = dequantize_pcm(wav).to(torch.float32).contiguous()
    raw_fn = fused_log_mel_raw if kernels else log_mel_raw_plain
    # the mel power is floored at the default 1e-10 whatever cfg.log_floor
    # says, as the JAX package's featurize_batch does (its jitted path
    # rebuilds the config without the floor); log_mel_spectrogram honours it
    feats = normalize_log_mel(
        raw_fn(wav, cfg.n_fft, cfg.hop_length, cfg.num_mels, cfg.mel_scale, BATCH_LOG_FLOOR),
        cfg,
    )
    if cfg.cmvn == "global":
        if not cfg.cmvn_stats_path:
            raise ValueError("cmvn='global' needs frontend.cmvn_stats_path")
        from .cmvn import apply_global_cmvn, load_cmvn

        mean, std = load_cmvn(cfg.cmvn_stats_path)
        feats = apply_global_cmvn(feats, mean, std)
    return feats
