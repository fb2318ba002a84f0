"""The port's resampling against the JAX package's ``frontend/resample.py``
(within 1e-5 absolute at the rates real recordings come at, the speed
perturbation's and the pitch shift's ratios; scipy's ``resample_poly`` on
the interior, the JAX test's bar), and real-format audio through every
entry point that used to refuse it: ``ModelBundle.transcribe`` (mixed
rates, files and arrays), ``api.featurize`` and the training loader, each
against its JAX twin on the same seeded audio."""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flacgen import write_flac  # noqa: E402
from test_torch_audio_io import needs_jax_native, write_wav_bytes  # noqa: E402

from jiao_liao_speech_recognition_tpu.data import manifest as jman  # noqa: E402
from jiao_liao_speech_recognition_tpu.data import pipeline as jpipe  # noqa: E402
from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JTok  # noqa: E402
from jiao_liao_speech_recognition_tpu.frontend import augment as jaug  # noqa: E402
from jiao_liao_speech_recognition_tpu.frontend.resample import resample as jresample  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.ctc_model import CTCEncoderModel as JModel  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import api  # noqa: E402
from jiao_liao_speech_recognition_torch.data import manifest as tman  # noqa: E402
from jiao_liao_speech_recognition_torch.data import pipeline as tpipe  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer as TTok  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle  # noqa: E402
from jiao_liao_speech_recognition_torch.models.ctc_model import CTCEncoderModel  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

# the package exports the function under the module's name
tres = importlib.import_module("jiao_liao_speech_recognition_torch.frontend.resample")

RESAMPLE_BAR = 1e-5  # f32 on both sides, the sum reordered
SCIPY_BAR = 5e-3  # the JAX test's interior bar against scipy's f64 resample_poly
LOGMEL_BAR = 2e-4

REAL_RATES = [(8000, 16000), (22050, 16000), (44100, 16000), (48000, 16000), (16000, 8000)]
SPEED_RATIOS = [jaug._rate_to_ratio(r) for r in (0.9, 1.1, 0.95, 1.05)]
PITCH_RATIOS = [jaug._rate_to_ratio(2.0 ** (s / 12.0), max_den=64) for s in (-2, -1, 1, 2)]


def _jax(x, orig, tgt):
    with jax.default_matmul_precision("highest"):
        return np.asarray(jresample(jnp.asarray(x), orig, tgt))


@pytest.mark.parametrize("orig,tgt", REAL_RATES + SPEED_RATIOS + PITCH_RATIOS)
def test_resample_matches_jax(orig, tgt):
    rng = np.random.RandomState(orig % 97 + tgt % 89)
    x = (0.3 * rng.randn(3, 7001)).astype(np.float32)
    got = tres.resample(torch.from_numpy(x), orig, tgt).numpy()
    want = _jax(x, orig, tgt)
    assert got.shape == want.shape == (3, -(-7001 * tgt // math.gcd(orig, tgt)
                                           // (orig // math.gcd(orig, tgt))))
    assert np.abs(got - want).max() < RESAMPLE_BAR
    one = tres.resample(torch.from_numpy(x[1]), orig, tgt).numpy()  # [T] -> [T']
    assert one.shape == got[1].shape and np.abs(one - got[1]).max() < RESAMPLE_BAR


@pytest.mark.parametrize("n", [0, 1, 5, 440, 16000])
def test_resample_short_inputs_match_jax(n):
    x = (0.3 * np.random.RandomState(n).randn(2, n)).astype(np.float32)
    for orig, tgt in ((44100, 16000), (8000, 16000), (89, 84)):
        got = tres.resample(torch.from_numpy(x), orig, tgt).numpy()
        if n == 0:  # nothing in, nothing out
            assert got.shape == (2, 0)
            continue
        want = _jax(x, orig, tgt)
        assert got.shape == want.shape and np.abs(got - want).max() < RESAMPLE_BAR


def test_resample_vs_scipy():
    from scipy.signal import resample_poly

    x = np.random.RandomState(0).randn(16000).astype(np.float32) * 0.3
    for orig, tgt in REAL_RATES:
        got = tres.resample(torch.from_numpy(x), orig, tgt).numpy()
        g = math.gcd(orig, tgt)
        ref = resample_poly(x.astype(np.float64), tgt // g, orig // g)
        n = min(len(got), len(ref))
        pad = 200  # the edges differ by padding convention
        assert np.abs(got[pad:n - pad] - ref[pad:n - pad]).max() < SCIPY_BAR, (orig, tgt)
    same = torch.from_numpy(x)
    assert tres.resample(same, 16000, 16000) is same


def test_design_filter_is_the_jax_packages():
    from jiao_liao_speech_recognition_tpu.frontend.resample import _design_filter

    for up, down in ((160, 441), (1, 3), (10, 9)):
        np.testing.assert_array_equal(tres._design_filter(up, down), _design_filter(up, down))


# --- the entry points ---------------------------------------------------------------

TINY = dict(d_model=64, num_layers=1, num_heads=2, mlp_dim=128, conv_channels=32, vocab_size=20,
            dtype="float32", use_flash_attention=False)


@pytest.fixture(scope="module")
def bundles():
    jexp = jcfg.ExperimentConfig(frontend=jcfg.FrontendConfig(chunk_seconds=2.0),
                                 ctc_model=jcfg.CTCModelConfig(**TINY))
    params = JModel(jexp.ctc_model).init(jax.random.PRNGKey(4),
                                         jnp.zeros((1, 80, 64), jnp.float32))["params"]
    vocab = [chr(0x4E00 + i) for i in range(TINY["vocab_size"] - 2)]
    model = CTCEncoderModel(tcfg.CTCModelConfig(**TINY))
    model.load_state_dict(convert.params_to_state_dict(params))
    texp = tcfg.ExperimentConfig(frontend=tcfg.FrontendConfig(chunk_seconds=2.0),
                                 ctc_model=tcfg.CTCModelConfig(**TINY))
    return (JBundle(config=jexp, params=params, tokenizer=JTok(vocab)),
            ModelBundle(texp, model.eval(), TTok(vocab)))


def _real_files(tmp_path, seed=0, secs=1.3):
    """The four formats of real recordings, each at its own rate: 44.1 kHz
    FLAC, 48 kHz 24-bit WAV, 22.05 kHz float WAV, 8 kHz 8-bit WAV."""
    rng = np.random.RandomState(seed)

    def sig(sr):
        t = np.arange(int(sr * secs)) / sr
        return 0.4 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.randn(len(t))

    paths = [tmp_path / "a.flac", tmp_path / "b.wav", tmp_path / "c.wav", tmp_path / "d.wav"]
    write_flac(paths[0], [np.round(sig(44100) * 32767).astype(np.int64)], sample_rate=44100,
               block_size=4096)
    write_wav_bytes(paths[1], np.round(sig(48000) * 8388607)[:, None], 48000, 24)
    write_wav_bytes(paths[2], sig(22050).astype(np.float32)[:, None], 22050, 32, fmt=3)
    write_wav_bytes(paths[3], np.round(sig(8000) * 127 + 128)[:, None], 8000, 8)
    return [str(p) for p in paths]


@needs_jax_native
def test_bundle_transcribes_real_formats_and_mixed_rates_like_jax(bundles, tmp_path):
    jb, tb = bundles
    files = _real_files(tmp_path)
    arr = (0.1 * np.random.RandomState(1).randn(30000)).astype(np.float32)  # 1.36 s at 22.05k
    with jax.default_matmul_precision("highest"):
        want = jb.transcribe(files)
        want_arr = jb.transcribe([arr, arr[:9000]], sample_rate=22050)
        want_mix = jb.transcribe([files[0], arr], sample_rate=22050)
    assert tb.transcribe(files) == want
    assert api.transcribe(tb, [arr, arr[:9000]], sample_rate=22050) == want_arr
    assert tb.transcribe([files[0], arr], sample_rate=22050) == want_mix
    # each item resampled to 16 kHz: the same lengths as JAX's
    for got, ref in zip(tb._collect_audio(files, None), jb._collect_audio(files, None)[0]):
        assert len(got) == len(ref) and np.abs(got - ref).max() < RESAMPLE_BAR


@needs_jax_native
def test_api_featurize_of_real_formats_matches_jax(tmp_path):
    """JAX's api.featurize takes the same route (read_audio, resample,
    pad_or_trim, featurize_batch) but stumbles over its own name for the
    resample module at other rates, so the JAX side is that route spelled
    out."""
    from jiao_liao_speech_recognition_tpu.frontend import audio_io as jio
    from jiao_liao_speech_recognition_tpu.frontend import features as jf

    fe_t, fe_j = tcfg.FrontendConfig(chunk_seconds=2.0), jcfg.FrontendConfig(chunk_seconds=2.0)
    arr = (0.1 * np.random.RandomState(2).randn(44100)).astype(np.float32)
    for src in _real_files(tmp_path)[:2] + [arr]:
        pcm, sr = (arr, 44100) if isinstance(src, np.ndarray) else jio.read_audio(src)
        with jax.default_matmul_precision("highest"):
            x = jresample(jnp.asarray(pcm), sr, 16000)
            want = np.asarray(jf.featurize_batch(
                jnp.asarray(jf.pad_or_trim(np.asarray(x), fe_j))[None], fe_j))
        kw = {"sample_rate": 44100} if isinstance(src, np.ndarray) else {}
        got = api.featurize(src, fe_t, device="cpu", **kw).numpy()
        assert got.shape == want.shape == (1, 80, 200)
        assert np.abs(got - want).max() < LOGMEL_BAR


@needs_jax_native
@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_training_loader_reads_real_formats_like_jax(tmp_path, wire):
    files = _real_files(tmp_path)
    rows = [tman.ManifestRow(f, "一二三"[:1 + i % 3], 1.3, "d") for i, f in enumerate(files)]
    tman.write_manifest(rows, tmp_path / "m.jsonl")
    jm, tm = jman.read_manifest(tmp_path / "m.jsonl"), tman.read_manifest(tmp_path / "m.jsonl")
    kw = dict(batch_size=4, bucket_boundaries_seconds=(2.0,), max_text_len=4, transfer_dtype=wire,
              max_audio_seconds=2.0)
    jtok = JTok.build(jm.texts())
    jit = jpipe.BatchIterator(jm, jtok, jcfg.DataConfig(**kw), process_index=0, process_count=1)
    tit = tpipe.BatchIterator(tm, TTok(jtok.vocab), tcfg.DataConfig(**kw))
    a, b = next(jit), next(tit)
    np.testing.assert_array_equal(b.audio_lengths, a.audio_lengths)
    assert (np.abs(b.audio_lengths - 1.3 * 16000) <= 1).all()  # every row at 16 kHz
    np.testing.assert_array_equal(b.labels, a.labels)
    diff = np.abs(b.audio.astype(np.float64) - a.audio.astype(np.float64)).max()
    # f32: the resampler's sum order; the int16 wire: at most one lsb apart
    assert diff < (RESAMPLE_BAR if wire == "float32" else 1.0 + 1e-9)
