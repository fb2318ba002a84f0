"""Host-side audio decode (the JAX package's ``frontend/audio_io.py``): WAV
through the C++ decoder (``native/wavio.cpp``) with the stdlib ``wave``
decoder as its fallback, FLAC through the C++ decoder
(``native/flacio.cpp``), which has none. Both libraries are built at first
use (``utils/native_ext.py``). Decoding stays on the host; the device
pipeline starts at float32 PCM. ``read_audio`` dispatches on the suffix.
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Tuple

import numpy as np

from ..utils import native_ext


class NativeDecoderUnavailable(RuntimeError):
    """A native decoder could not be built (no compiler, or it failed)."""


def read_audio(path: str | Path) -> Tuple[np.ndarray, int]:
    """WAV or FLAC -> (mono float32 PCM in [-1, 1], sample_rate), by the
    file's suffix."""
    if str(path).lower().endswith(".flac"):
        return read_flac(path)
    return read_wav(path)


def read_flac(path: str | Path) -> Tuple[np.ndarray, int]:
    """Decode FLAC through ``native/flacio.cpp``; raises
    ``NativeDecoderUnavailable`` when the library cannot be built."""
    try:
        flac = native_ext.load_flacio()
    except RuntimeError as e:
        raise NativeDecoderUnavailable(
            f"{path}: FLAC decoding needs native/flacio.cpp built (a C++ compiler on the "
            f"PATH, or `python -m jiao_liao_speech_recognition_torch.cli build-native`): {e}"
        ) from e
    return flac.read(str(path))


def read_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    """WAV -> (mono float32 PCM in [-1, 1], sample_rate): 8/16/24/32-bit
    integer PCM and 32-bit float. Channels are averaged. The C++ decoder
    first; where it cannot be built or cannot decode the file, the stdlib
    decoder (integer PCM only)."""
    try:
        return native_ext.load_wavio().read(str(path))
    except (RuntimeError, OSError):
        return _read_wav_py(path)


def _read_wav_py(path: str | Path) -> Tuple[np.ndarray, int]:
    with wave.open(str(path), "rb") as wf:
        sr = wf.getframerate()
        ch = wf.getnchannels()
        sw = wf.getsampwidth()
        raw = wf.readframes(wf.getnframes())
    if sw == 2:
        pcm = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:  # wave opens integer PCM only, so 4 bytes are int32
        pcm = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:
        pcm = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sw == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        i32 = b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8) | (
            b[:, 2].astype(np.int32) << 16)
        i32 = np.where(i32 & 0x800000, i32 - 0x1000000, i32)
        pcm = i32.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"unsupported WAV sample width {sw} in {path}")
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
