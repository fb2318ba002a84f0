"""The port's audio input against the JAX package's: ``read_audio`` /
``read_wav`` / ``read_flac`` give JAX's arrays bit for bit on 8/16/24/32-bit
PCM, float and stereo WAV (the C++ decoder, and the stdlib decoder where it
cannot be built) and on FLAC of every subframe kind and stereo mode
written by ``tests/flacgen.py``; a FLAC decoder that cannot be built is a
named error. The WAVs are written here byte by byte from seeded numpy."""

import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacgen import write_flac  # noqa: E402

from jiao_liao_speech_recognition_tpu.frontend import audio_io as jio  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import native_ext as jnative  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend import audio_io as tio  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import native_ext  # noqa: E402

needs_jax_native = pytest.mark.skipif(
    not (jnative.native_available("wavio") and jnative.native_available("flacio")),
    reason="the JAX package's native decoders are not built (no g++)")


def write_wav_bytes(path, frames: np.ndarray, sample_rate: int, bits: int, fmt: int = 1):
    """frames [n, channels] of integer codes (fmt 1, PCM) or float32 (fmt
    3) -> a RIFF/WAVE file with one fmt chunk and one data chunk."""
    ch = frames.shape[1]
    if fmt == 3:
        data = frames.astype("<f4").tobytes()
    elif bits == 8:
        data = frames.astype(np.uint8).tobytes()
    elif bits == 24:
        v = frames.astype("<i4").reshape(-1)
        data = np.stack([v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF], 1).astype(np.uint8).tobytes()
    else:
        data = frames.astype({16: "<i2", 32: "<i4"}[bits]).tobytes()
    block = ch * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", fmt, ch, sample_rate, sample_rate * block, block, bits)
    body = b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt_chunk + b"data" + \
        struct.pack("<I", len(data)) + data
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def wav_case(tmp_path, bits: int, channels: int, fmt: int = 1, n: int = 1500, seed: int = 0,
             sample_rate: int = 22050):
    rng = np.random.RandomState(seed + bits + channels)
    if fmt == 3:
        frames = rng.uniform(-1, 1, (n, channels)).astype(np.float32)
    elif bits == 8:
        frames = rng.randint(0, 256, (n, channels))
    else:
        hi = 1 << (bits - 1)
        frames = rng.randint(-hi, hi, (n, channels), dtype=np.int64)
        frames[:4] = [[-hi] * channels, [hi - 1] * channels, [0] * channels, [-1] * channels]
    p = tmp_path / f"w{bits}_{channels}_{fmt}.wav"
    write_wav_bytes(p, frames, sample_rate, bits, fmt)
    return p


WAV_CASES = [(8, 1, 1), (16, 1, 1), (24, 1, 1), (32, 1, 1), (32, 1, 3), (16, 2, 1),
             (24, 2, 1), (32, 2, 3)]


@needs_jax_native
@pytest.mark.parametrize("bits,channels,fmt", WAV_CASES)
def test_read_wav_native_route_equals_jax_bitwise(tmp_path, bits, channels, fmt):
    p = wav_case(tmp_path, bits, channels, fmt)
    got, sr = tio.read_wav(p)
    want, jsr = jio.read_wav(p)
    assert sr == jsr == 22050 and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tio.read_audio(p)[0], want)
    assert np.abs(got).max() <= 1.0 and len(got) == 1500


@pytest.mark.parametrize("bits,channels,fmt", WAV_CASES)
def test_read_wav_stdlib_route_equals_jax_bitwise(tmp_path, bits, channels, fmt, monkeypatch):
    """Without a C++ compiler the stdlib decoder reads integer PCM as the
    JAX package's does; float WAV, which the stdlib ``wave`` cannot open,
    raises in both."""
    p = wav_case(tmp_path, bits, channels, fmt)

    def no_compiler():
        raise RuntimeError("no C++ compiler (g++) on the PATH")

    monkeypatch.setattr(native_ext, "load_wavio", no_compiler)
    if fmt == 3:
        with pytest.raises(Exception) as got_err:
            tio.read_wav(p)
        with pytest.raises(Exception) as want_err:
            jio._read_wav_py(p)
        assert type(got_err.value) is type(want_err.value)
        return
    got, sr = tio.read_wav(p)
    want, jsr = jio._read_wav_py(p)
    assert sr == jsr
    np.testing.assert_array_equal(got, want)


def test_wav_write_read_round_trip_is_the_jax_packages(tmp_path):
    pcm = np.random.RandomState(3).uniform(-1.2, 1.2, 4000).astype(np.float32)
    tio.write_wav(tmp_path / "t.wav", pcm, 16000)
    jio.write_wav(tmp_path / "j.wav", pcm, 16000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    np.testing.assert_array_equal(tio.read_wav(tmp_path / "t.wav")[0],
                                  jio.read_wav(tmp_path / "j.wav")[0])


def _flac_signal(n, rng, amp):
    t = np.arange(n) / 16000.0
    return np.round(amp * np.sin(2 * np.pi * 440 * t) + rng.randint(-50, 50, n)).astype(np.int64)


FLAC_CASES = [("verbatim", "independent", 1, 16), ("fixed", "independent", 1, 16),
              ("lpc", "independent", 1, 16), ("constant", "independent", 1, 16),
              ("fixed", "left_side", 2, 16), ("fixed", "right_side", 2, 16),
              ("lpc", "mid_side", 2, 16), ("fixed", "independent", 1, 24),
              ("verbatim", "independent", 2, 8)]


@needs_jax_native
@pytest.mark.parametrize("kind,stereo,channels,bps", FLAC_CASES)
def test_read_flac_equals_jax_bitwise(tmp_path, kind, stereo, channels, bps):
    rng = np.random.RandomState(channels * 7 + bps)
    amp = {8: 60, 16: 2000, 24: 500_000}[bps]
    n = 1000  # four 256-sample blocks, the last one partial
    chans = [np.full(n, -123, np.int64)] if kind == "constant" else \
        [_flac_signal(n, rng, amp) for _ in range(channels)]
    p = tmp_path / f"{kind}_{stereo}_{bps}.FLAC"
    write_flac(p, chans, sample_rate=44100, bps=bps, subframe_kind=kind, stereo_mode=stereo,
               block_size=256)
    got, sr = tio.read_audio(p)  # the suffix dispatch is case-blind
    want, jsr = jio.read_audio(p)
    assert sr == jsr == 44100 and len(got) == n
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tio.read_flac(p)[0], want)
    scale = 1.0 / (1 << (bps - 1))
    expect = np.mean([c.astype(np.float64) * scale for c in chans], axis=0)
    assert np.abs(got - expect).max() < 1e-6


def test_flac_without_its_decoder_is_a_named_error(tmp_path, monkeypatch):
    def failed_build():
        raise RuntimeError("g++ ... native/flacio.cpp failed (rc=1)")

    monkeypatch.setattr(native_ext, "load_flacio", failed_build)
    with pytest.raises(tio.NativeDecoderUnavailable, match="flacio.cpp"):
        tio.read_audio(tmp_path / "x.flac")


def test_decoders_reject_garbage(tmp_path):
    (tmp_path / "bad.flac").write_bytes(b"not a flac stream at all")
    with pytest.raises(IOError, match="flacio"):
        tio.read_audio(tmp_path / "bad.flac")
    (tmp_path / "bad.wav").write_bytes(b"RIFF....WAVEjunk")
    with pytest.raises(Exception):
        tio.read_wav(tmp_path / "bad.wav")
