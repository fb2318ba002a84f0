"""WAV input for the greedy slice: 16-bit PCM through the stdlib ``wave``
module. (FLAC, other sample widths and the C++ decoders come with a later
slice.)"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Tuple

import numpy as np


def read_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    """-> (mono float32 PCM in [-1, 1), sample_rate). Channels are averaged."""
    with wave.open(str(path), "rb") as wf:
        sr = wf.getframerate()
        ch = wf.getnchannels()
        sw = wf.getsampwidth()
        raw = wf.readframes(wf.getnframes())
    if sw != 2:
        raise ValueError(f"{path}: {8 * sw}-bit WAV; only 16-bit PCM is read here")
    pcm = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if ch > 1:
        pcm = pcm.reshape(-1, ch).mean(axis=1)
    return pcm, sr


def write_wav(path: str | Path, pcm: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 PCM to a 16-bit WAV (the JAX package's scaling:
    clip to [-1, 1], times 32767, truncated)."""
    pcm16 = np.clip(np.asarray(pcm, dtype=np.float32), -1.0, 1.0)
    pcm16 = (pcm16 * 32767.0).astype("<i2")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sample_rate)
        wf.writeframes(pcm16.tobytes())
