"""The port's frontend (numpy basis twins, plain log-mel = K1's plain
version, featurize_batch, CMVN, WAV input) against the JAX package's, which
runs on the CPU as its own tests run it (XLA path, and the Pallas K1 kernel
in interpret mode)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.frontend import audio_io as j_audio  # noqa: E402
from jiao_liao_speech_recognition_tpu.frontend import features as jf  # noqa: E402
from jiao_liao_speech_recognition_tpu.frontend.pallas_frontend import (  # noqa: E402
    fused_log_mel_raw as j_fused_raw,
)
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend import audio_io, cmvn  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend import features as tf  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend import fused_frontend  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

# the JAX package's log-mel parity bar (docs/COMPONENTS.md C3): both sides
# compute in f32 and differ only in summation order
LOGMEL_BAR = 2e-4
# fbank (natural log, no Whisper tail) of the same f32 arithmetic, in log units
FBANK_BAR = 1e-5
# and its output after utterance CMVN, in normalised units: the log-unit
# difference divided by stds down to 0.028 (measured 3.5e-5)
FBANK_CMVN_BAR = 1e-4


def _wavs(B=2, secs=1.3, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(16000 * secs)) / 16000.0
    rows = [
        0.3 * np.sin(2 * np.pi * (300.0 + 500 * b) * t) + 0.05 * rng.randn(len(t))
        for b in range(B)
    ]
    rows[-1] = rows[-1] * 0.01  # a quiet row: deeper spectral valleys
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("n_fft", [400, 512])
def test_dft_basis_twin_is_exact(n_fft):
    np.testing.assert_array_equal(tf._dft_basis(n_fft), jf._dft_basis(n_fft))


@pytest.mark.parametrize("num_mels,scale", [(80, "slaney"), (128, "slaney"), (80, "htk")])
def test_mel_filterbank_twin_is_exact(num_mels, scale):
    got = tf.mel_filterbank(num_mels, 400, scale=scale)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jf.mel_filterbank(num_mels, 400, scale=scale))


def test_plain_log_mel_matches_jax_log_mel_spectrogram():
    wav = _wavs()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jf.log_mel_spectrogram(jnp.asarray(wav), jcfg.FrontendConfig()))
    got = tf.log_mel_spectrogram(torch.from_numpy(wav), tcfg.FrontendConfig()).numpy()
    assert got.shape == want.shape == (2, 80, 130)
    np.testing.assert_allclose(got, want, atol=LOGMEL_BAR, rtol=0)


@pytest.mark.parametrize("kw", [
    None,  # the recipe default: preemphasis 0.97, utterance CMVN, no Whisper tail
    dict(whisper_norm=False, cmvn="utterance", preemphasis=0.0),
    dict(whisper_norm=False, cmvn="none", preemphasis=0.97),
    dict(whisper_norm=False, cmvn="none", preemphasis=0.0),
])
def test_fbank_matches_jax(kw):
    """Within FBANK_BAR in log units: utterance CMVN divides each (utterance,
    mel) row by its std over time, which is 0.028 in this quiet row, so
    there the difference times that std is held to the bar, and the
    normalised output itself to FBANK_CMVN_BAR."""
    wav = _wavs(secs=1.0)
    cfg = dict(whisper_norm=False, cmvn="utterance", preemphasis=0.97) if kw is None else kw
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jf.fbank(jnp.asarray(wav), kw and jcfg.FrontendConfig(**kw)))
        log = np.asarray(jf.fbank(jnp.asarray(wav), jcfg.FrontendConfig(**{**cfg, "cmvn": "none"})))
    got = tf.fbank(torch.from_numpy(wav), kw and tcfg.FrontendConfig(**kw)).numpy()
    assert got.shape == want.shape == (2, 80, 100)
    scale = log.std(axis=2, keepdims=True) if cfg["cmvn"] == "utterance" else 1.0
    assert (np.abs(got - want) * scale).max() <= FBANK_BAR
    assert np.abs(got - want).max() <= (FBANK_CMVN_BAR if cfg["cmvn"] == "utterance" else FBANK_BAR)
    one = tf.fbank(torch.from_numpy(wav[0]), kw and tcfg.FrontendConfig(**kw)).numpy()
    np.testing.assert_array_equal(one, got[:1])


def test_plain_log_mel_matches_k1_interpret():
    wav = _wavs(seed=1)
    want = np.asarray(j_fused_raw(jnp.asarray(wav)))  # Pallas kernel, interpret mode
    got = fused_frontend.log_mel_raw_plain(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=LOGMEL_BAR, rtol=0)
    # the K1 wrapper takes the plain version for a CPU tensor, bit for bit
    via_wrapper = fused_frontend.fused_log_mel_raw(torch.from_numpy(wav)).numpy()
    np.testing.assert_array_equal(via_wrapper, got)


def test_k1_wrapper_refuses_a_device_it_has_no_kernel_for():
    with pytest.raises(ValueError, match="CUDA"):
        fused_frontend.fused_log_mel_raw(torch.empty(1, 8000, device="meta"))


def test_kernel_constants_hold_the_basis_in_the_kernels_layout():
    """K1's constants (csrc/log_mel_tf32.cu): the basis [416 columns][416 k]
    with cos and sin in 8-frequency groups (row 16 q + e: cos of frequency
    8 q + e, row 16 q + 8 + e: its -sin), zero past n_fft and n_freqs, split
    into TF32 hi and lo (low 13 bits clear, hi + lo within 2^-21 of the f32
    basis); the mel filterbank and each filter's band of nonzero columns."""
    hi, lo, mel, bands = fused_frontend._kernel_constants(400, 80, "slaney", "cpu")
    b = jf._dft_basis(400)  # [402, 400]: cos rows, then -sin rows
    assert tuple(hi.shape) == tuple(lo.shape) == (416, 416) and hi.dtype == torch.float32
    assert tuple(mel.shape) == (80, 201) and tuple(bands.shape) == (80, 2)
    full = fused_frontend.tf32_basis(400)
    for f in (0, 1, 7, 8, 100, 200):
        q, e = divmod(f, 8)
        np.testing.assert_array_equal(full[16 * q + e, :400], b[f])
        np.testing.assert_array_equal(full[16 * q + 8 + e, :400], b[201 + f])
    assert not full[:, 400:].any()
    assert not full[16 * 25 + 1:16 * 25 + 8].any() and not full[16 * 25 + 9:].any()
    for t in (hi, lo):
        assert not (t.numpy().view(np.uint32) & 0x1FFF).any()
    np.testing.assert_allclose((hi.double() + lo.double()).numpy(), full,
                               rtol=2.0 ** -21, atol=0)
    m = mel.numpy()
    for row, (first, end) in zip(m, bands.numpy()):
        assert row[first] != 0 and row[end - 1] != 0
        assert not row[:first].any() and not row[end:].any()


def test_p1_constants_keep_their_own_layout():
    """P1's reference constants (ops/probes.py, the plain version's layout)
    stay apart from K1's: bf16 hi and lo [n_k = 400][2 f16 = 416], cos in
    columns [0, 201), -sin in [208, 409), zero elsewhere."""
    from jiao_liao_speech_recognition_torch.ops import probes

    hi, lo, mel = probes._bf16x3_constants(400, 80, "cpu")
    b = jf._dft_basis(400)
    assert tuple(hi.shape) == tuple(lo.shape) == (400, 416) and hi.dtype == torch.bfloat16
    full = hi.double() + lo.double()
    np.testing.assert_allclose(full[:, :201].numpy(), b[:201].T, rtol=2.0 ** -15, atol=1e-12)
    np.testing.assert_allclose(full[:, 208:409].numpy(), b[201:].T, rtol=2.0 ** -15, atol=1e-12)
    assert not full[:, 201:208].any() and not full[:, 409:].any()
    assert tuple(mel.shape) == (80, 201)


def _deinterleave(basis, n_fft=400):
    """K1's layout [416 columns][416 k] -> the plain layout [n_fft k][cos |
    -sin] (402 columns): row 16 q + e is cos of frequency 8 q + e, row
    16 q + 8 + e its -sin."""
    f = np.arange(n_fft // 2 + 1)
    rows = np.concatenate([16 * (f // 8) + f % 8, 16 * (f // 8) + 8 + f % 8])
    return basis[rows, :n_fft].T


def test_p1_kernel_basis_is_k1s_layout_split_into_bf16():
    """P1's kernel operands (csrc/log_mel_tf32.cu's bf16 instance): K1's
    basis split by fused_frontend.bf16_split, bf16 [416][416], zero past
    n_fft and n_freqs; de-interleaved, its hi and lo are the reference
    constants' (probes._bf16x3_constants) bit for bit; the mel matrix is
    the reference's and the bands are K1's."""
    from jiao_liao_speech_recognition_torch.ops import probes

    hi, lo, mel, bands = probes._bf16x3_kernel_constants(400, 80, "cpu")
    ref_hi, ref_lo, ref_mel = probes._bf16x3_constants(400, 80, "cpu")
    assert tuple(hi.shape) == tuple(lo.shape) == (416, 416) and hi.dtype == torch.bfloat16
    bits = [t.view(torch.int16).numpy() for t in (hi, lo, ref_hi, ref_lo)]
    cols = np.r_[0:201, 208:409]  # the reference's cos | -sin columns
    np.testing.assert_array_equal(_deinterleave(bits[0]), bits[2][:, cols])
    np.testing.assert_array_equal(_deinterleave(bits[1]), bits[3][:, cols])
    full = fused_frontend.tf32_basis(400)
    for t in (hi, lo):
        assert not t[full == 0].any() and not t[:, 400:].any()
    # hi carries full's bf16 rounding, lo the rest, rounded again
    np.testing.assert_array_equal(hi.float().numpy(),
                                  torch.from_numpy(full).to(torch.bfloat16).float().numpy())
    np.testing.assert_allclose((hi.double() + lo.double()).numpy(), full, rtol=2.0 ** -16, atol=0)
    np.testing.assert_array_equal(mel.numpy(), ref_mel.numpy())
    _, _, _, k1_bands = fused_frontend._kernel_constants(400, 80, "slaney", "cpu")
    np.testing.assert_array_equal(bands.numpy(), k1_bands.numpy())


def test_p1_products_through_k1s_layout_are_the_plain_versions():
    """The three bf16 products of P1's kernel, lo.hi + hi.lo + hi.hi of the
    frames' bf16 split and the interleaved basis, taken exactly (f64) and
    de-interleaved, equal the same exact products of the plain version's
    operands (probes._split_bf16 of the frames and of _dft_basis); the
    plain version's f32 proj lies within f32 summation error of them."""
    from jiao_liao_speech_recognition_torch.ops import probes

    wav = torch.from_numpy(_wavs(B=1, secs=0.5, seed=3))
    frames = torch.nn.functional.pad(wav[:, None], (200, 200), mode="reflect")[:, 0]
    frames = frames.unfold(-1, 400, 160)[:, :-1]  # [1, 50, 400]
    f_hi, f_lo = probes._split_bf16(frames)
    hi, lo, _, _ = probes._bf16x3_kernel_constants(400, 80, "cpu")
    kh, kl = (torch.from_numpy(_deinterleave(t.float().numpy())).double() for t in (hi, lo))
    fh, fl = f_hi.double(), f_lo.double()
    kernel = fl @ kh + fh @ kl + fh @ kh
    b_hi, b_lo = probes._split_bf16(torch.from_numpy(tf._dft_basis(400).T.copy()))
    bh, bl = b_hi.double(), b_lo.double()
    plain_exact = fh @ bh + fl @ bh + fh @ bl
    np.testing.assert_allclose(kernel.numpy(), plain_exact.numpy(), rtol=0, atol=1e-12)
    proj = f_hi @ b_hi + f_lo @ b_hi + f_hi @ b_lo  # the plain version's f32 sums
    scale = float(plain_exact.abs().max())
    assert float((proj.double() - plain_exact).abs().max()) <= 1e-6 * scale


def _emulate_k1(wav, n_fft=400, hop=160, num_mels=80):
    """csrc/log_mel_tf32.cu's arithmetic on the CPU: the reflect-padded
    frames and K1's basis each split into TF32 hi and lo (tf32_split),
    hi.hi + hi.lo + lo.hi with exact products summed in f64 and rounded
    to f32 (the tensor cores' f32 accumulation differs only in order),
    power as re^2 + im^2 in f32, the mel product over each band, log10."""
    pad = n_fft // 2
    x = np.pad(wav, ((0, 0), (pad, pad)), mode="reflect")
    T = wav.shape[1] // hop
    frames = x[:, np.arange(T)[:, None] * hop + np.arange(n_fft)[None]]
    fh, fl = (a.astype(np.float64) for a in fused_frontend.tf32_split(frames))
    bh, bl = (a[:, :n_fft].astype(np.float64).T
              for a in fused_frontend.tf32_split(fused_frontend.tf32_basis(n_fft)))
    y = (fh @ bh + fh @ bl + fl @ bh).astype(np.float32)  # [B, T, 416]
    f = np.arange(n_fft // 2 + 1)
    re, im = y[..., 16 * (f // 8) + f % 8], y[..., 16 * (f // 8) + 8 + f % 8]
    mel = tf.mel_filterbank(num_mels, n_fft)
    power = re * re + im * im
    return np.log10(np.maximum(power @ mel.T, 1e-10)).transpose(0, 2, 1)


def _log_mel_f64(wav, n_fft=400, hop=160, num_mels=80):
    """The log-mel in float64 throughout (numpy), the result as f32."""
    x = np.pad(wav.astype(np.float64), ((0, 0), (n_fft // 2, n_fft // 2)), mode="reflect")
    T = wav.shape[1] // hop
    y = x[:, np.arange(T)[:, None] * hop + np.arange(n_fft)[None]] @ tf._dft_basis(n_fft).T
    n = n_fft // 2 + 1
    spec = (y[..., :n] ** 2 + y[..., n:] ** 2) @ tf.mel_filterbank(num_mels, n_fft).T
    return np.log10(np.maximum(spec, 1e-10)).transpose(0, 2, 1).astype(np.float32)


def test_k1_tf32x3_emulation_within_the_bar_of_jax_log_mel():
    """The 3xTF32 split on chip_smoke.py's four K1 rows (30 s: tones and
    noise, two quiet rows with deep spectral valleys) and on two rows of
    the P1 profiler's seeded input, held to LOGMEL_BAR against JAX's
    log_mel_spectrogram (HIGHEST precision) on the Whisper-normalized
    surface; the margin is printed, and on the four rows the emulation's
    and the port's f32 plain version's distance from an f64 log-mel."""
    import importlib.util
    from pathlib import Path

    rng = np.random.RandomState(0)  # chip_smoke.phase_kernels' K1 rows
    t = np.arange(30 * 16000) / 16000
    rows = np.stack([a * np.sin(2 * np.pi * f * t) + n * rng.randn(len(t)) for a, f, n in (
        (0.3, 440.0, 0.05), (0.1, 1200.0, 0.01), (0.0, 1.0, 0.1), (0.02, 300.0, 0.0005))])
    path = Path(__file__).resolve().parents[1] / "examples" / "torch_profile_frontend_precision.py"
    spec = importlib.util.spec_from_file_location("p1_profiler", path)
    p1 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(p1)
    p1_rows = p1.make_inputs(2, 30.0, device="cpu")[0].numpy()
    wav = np.concatenate([rows.astype(np.float32), p1_rows])
    emulated = _emulate_k1(wav)

    def norm(a):
        return tf.normalize_log_mel(torch.from_numpy(np.asarray(a)), tcfg.FrontendConfig()).numpy()

    four = wav[:4]
    exact, plain = norm(_log_mel_f64(four)), norm(fused_frontend.log_mel_raw_plain(
        torch.from_numpy(four)).numpy())
    print(f"K1 3xTF32 emulation on the four rows: {np.abs(norm(emulated[:4]) - exact).max():.3e}"
          f" from f64, plain f32 {np.abs(plain - exact).max():.3e} from f64, emulation "
          f"{np.abs(norm(emulated[:4]) - plain).max():.3e} from plain")
    got = norm(emulated)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jf.log_mel_spectrogram(jnp.asarray(wav), jcfg.FrontendConfig()))
    err = float(np.abs(got - want).max())
    print(f"K1 3xTF32 emulation: max |diff| {err:.3e} on the normalized surface, "
          f"bar {LOGMEL_BAR}, margin {LOGMEL_BAR - err:.3e}")
    assert got.shape == want.shape == (6, 80, 3000)
    assert err <= LOGMEL_BAR


@pytest.mark.parametrize("cmvn_mode", ["none", "utterance", "global"])
@pytest.mark.parametrize("int16", [False, True])
def test_featurize_batch_matches_jax(tmp_path, cmvn_mode, int16):
    wav = _wavs(secs=2.0, seed=2)
    if int16:
        wav = (wav * 32767).astype(np.int16)
    stats = ""
    if cmvn_mode == "global":
        stats = str(tmp_path / "cmvn.npz")
        rng = np.random.RandomState(3)
        np.savez(stats, mean=rng.randn(80).astype(np.float32),
                 std=(1 + rng.rand(80)).astype(np.float32), count=10)
    jc = jcfg.FrontendConfig(cmvn=cmvn_mode, cmvn_stats_path=stats)
    tc = tcfg.FrontendConfig(cmvn=cmvn_mode, cmvn_stats_path=stats)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jf.featurize_batch(jnp.asarray(wav), jc))
    got = tf.featurize_batch(torch.from_numpy(wav), tc).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=LOGMEL_BAR, rtol=0)


def test_featurize_batch_floors_as_jax_whatever_log_floor_says():
    """The JAX package's featurize_batch floors the mel power at 1e-10
    whatever cfg.log_floor says (its jitted path rebuilds the config
    without it); the port's does the same. 2 s of noise at 1e-4 amplitude,
    the second second silent, where a 1e-3 floor would move every frame of
    the silent half (by up to 1.75 once normalized)."""
    rng = np.random.RandomState(4)
    wav = (1e-4 * rng.randn(1, 32000)).astype(np.float32)
    wav[:, 16000:] = 0.0
    jc = jcfg.FrontendConfig(log_floor=1e-3)
    tc = tcfg.FrontendConfig(log_floor=1e-3)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jf.featurize_batch(jnp.asarray(wav), jc))
    got = tf.featurize_batch(torch.from_numpy(wav), tc).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=LOGMEL_BAR, rtol=0)
    # log_mel_spectrogram honours the floor in both packages
    with jax.default_matmul_precision("highest"):
        want_floor = np.asarray(jf.log_mel_spectrogram(jnp.asarray(wav), jc))
    got_floor = tf.log_mel_spectrogram(torch.from_numpy(wav), tc).numpy()
    np.testing.assert_allclose(got_floor, want_floor, atol=LOGMEL_BAR, rtol=0)
    assert float(np.abs(got_floor - got).max()) > 100 * LOGMEL_BAR


def test_dequantize_pad_and_cmvn_twins():
    pcm = np.array([-32768, -1, 0, 1, 32767], np.int16)
    np.testing.assert_array_equal(
        tf.dequantize_pcm(torch.from_numpy(pcm)).numpy(),
        np.asarray(jf.dequantize_pcm(jnp.asarray(pcm))),
    )
    f = torch.ones(3)
    assert tf.dequantize_pcm(f) is f
    fe_t, fe_j = tcfg.FrontendConfig(chunk_seconds=0.5), jcfg.FrontendConfig(chunk_seconds=0.5)
    for n in (100, 8000, 9000):
        x = np.random.RandomState(n).randn(n).astype(np.float32)
        np.testing.assert_array_equal(tf.pad_or_trim(x, fe_t), jf.pad_or_trim(x, fe_j))
    feats = np.random.RandomState(4).randn(2, 80, 30).astype(np.float32)
    mean, std = np.arange(80, dtype=np.float32), np.full(80, 2.0, np.float32)
    from jiao_liao_speech_recognition_tpu.frontend.cmvn import apply_global_cmvn

    np.testing.assert_allclose(
        cmvn.apply_global_cmvn(torch.from_numpy(feats), mean, std).numpy(),
        np.asarray(apply_global_cmvn(jnp.asarray(feats), mean, std)), rtol=1e-6,
    )


def test_read_wav_matches_jax_reader(tmp_path):
    rng = np.random.RandomState(5)
    pcm = (0.5 * rng.randn(16000)).clip(-1, 1).astype(np.float32)
    path = tmp_path / "a.wav"
    j_audio.write_wav(path, pcm, 16000)
    got, sr = audio_io.read_wav(path)
    want, jsr = j_audio._read_wav_py(path)
    assert sr == jsr == 16000
    np.testing.assert_array_equal(got, want)
