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
    basis, mel = fused_frontend._kernel_constants(400, 80, "slaney", "cpu")
    b = jf._dft_basis(400)
    assert tuple(basis.shape) == (416, 512) and tuple(mel.shape) == (80, 201)
    np.testing.assert_array_equal(basis[:400, :201].numpy(), b[:201].T)
    np.testing.assert_array_equal(basis[:400, 256:457].numpy(), b[201:].T)
    assert not basis[400:].any() and not basis[:, 201:256].any() and not basis[:, 457:].any()


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
