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
