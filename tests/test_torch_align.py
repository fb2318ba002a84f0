"""The port's Whisper timestamps (decode/align.py, ModelBundle.
transcribe_timed) against the JAX package's, on the CPU: the tiny f32
Whisper of tests/test_torch_serve.py (JAX's seed-0 weights carried into the
port by models/convert.py).

* cross_attention_matrix within F32_BAR of JAX's, over every head and over
  a selection of alignment_heads;
* dtw_spans equal to JAX's on seeded matrices (T >= S and T < S);
* whisper_token_spans and transcribe_timed equal to JAX's: tokens, starts
  and ends, one window, a long-form recording, a quantized bundle."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JChar  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode import align as jalign  # noqa: E402
from jiao_liao_speech_recognition_tpu.frontend import features as jfeatures  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import api  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer  # noqa: E402
from jiao_liao_speech_recognition_torch.decode import align as talign  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend import features as tfeatures  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

TINY = dict(vocab_size=96, d_model=64, encoder_layers=1, decoder_layers=2, num_heads=2,
            mlp_dim=128, max_source_positions=32, max_target_positions=16, prompt_ids=(1, 3),
            eot_id=2, dtype="float32", use_flash_attention=False)
VOCAB = [chr(0x4E00 + i) for i in range(94)]
# f32 attention probabilities of the same pass in both packages: sums reordered
F32_BAR = 1e-5


def _pair(**extra):
    """(JAX bundle, port bundle) on JAX's seed-0 weights; extra whisper
    fields (alignment_heads) on both."""
    cfgs = []
    for m in (jcfg, tcfg):
        cfg = m.ExperimentConfig(model_family="whisper",
                                 whisper=m.WhisperConfig(**{**TINY, **extra}))
        cfg.frontend.chunk_seconds = 0.64
        cfg.decode.max_decode_len = 12
        cfgs.append(cfg)
    params = JBundle._init_params(cfgs[0])
    jb = JBundle(config=cfgs[0], params=params, tokenizer=JChar(VOCAB))
    tb = api.load(config=cfgs[1], device="cpu")
    tb.model.load_state_dict(convert.whisper_params_to_state_dict(params))
    tb.tokenizer = CharTokenizer(VOCAB)
    return jb, tb


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _audio(seconds, seed):
    return (np.random.RandomState(seed).randn(int(16000 * seconds)) * 0.1).astype(np.float32)


def _mels(jb, tb, wavs):
    batch = np.stack([jfeatures.pad_or_trim(w, jb.config.frontend) for w in wavs])
    with jax.default_matmul_precision("highest"):
        jmel = jfeatures.featurize_batch(jnp.asarray(batch), jb.config.frontend)
    return jmel, tfeatures.featurize_batch(torch.from_numpy(batch), tb.config.frontend)


@pytest.mark.parametrize("heads", [(), ((1, 0),), ((0, 1), (1, 0), (1, 1))])
def test_cross_attention_matrix_matches_jax(heads):
    jb, tb = _pair(alignment_heads=heads)
    jmel, tmel = _mels(jb, tb, [_audio(0.6, 1), _audio(0.3, 2)])
    tokens = np.random.RandomState(3).randint(4, 90, (2, 9))
    tokens[:, :2] = (1, 3)
    with jax.default_matmul_precision("highest"):
        want = jalign.cross_attention_matrix(jb.config.whisper, jb.params, jmel, tokens)
    got = talign.cross_attention_matrix(tb.model, tmel, tokens)
    assert got.shape == want.shape == (2, 9, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)  # rows stay distributions
    assert np.abs(got - want).max() < F32_BAR


def test_alignment_heads_outside_the_model_raise(pair):
    _, tb = pair
    model = tb.model
    model.cfg = dataclasses.replace(model.cfg, alignment_heads=((7, 0),))
    try:
        with pytest.raises(ValueError, match="no cross-attention captured"):
            talign.cross_attention_matrix(model, torch.zeros(1, 80, 64), np.ones((1, 4), int))
    finally:
        model.cfg = tb.config.whisper


@pytest.mark.parametrize("seed", range(6))
def test_dtw_spans_equal_jax(seed):
    rng = np.random.RandomState(seed)
    S, T = rng.randint(1, 12), rng.randint(1, 40)
    A = rng.dirichlet(np.ones(T), size=S)
    assert talign.dtw_spans(A) == jalign.dtw_spans(A)
    assert talign.dtw_spans(A[:0]) == jalign.dtw_spans(A[:0]) == []


def test_whisper_token_spans_match_jax(pair):
    jb, tb = pair
    jmel, tmel = _mels(jb, tb, [_audio(0.6, 4), _audio(0.2, 5), _audio(0.5, 6)])
    rng = np.random.RandomState(7)
    gen = rng.randint(4, 90, (3, 10))
    lens = np.array([10, 0, 5])
    valid = np.array([30, 10, 25])
    with jax.default_matmul_precision("highest"):
        want = jalign.whisper_token_spans(jb.config.whisper, jb.params, jmel, gen, lens, (1, 3),
                                          2, valid)
    got = talign.whisper_token_spans(tb.model, tmel, gen, lens, (1, 3), 2, valid)
    assert got == want and [len(s) for s in got] == [10, 0, 5]


@pytest.mark.parametrize("case", ["one_window", "long_form", "quantized"])
def test_transcribe_timed_matches_jax(pair, case):
    jb, tb = pair
    audio = [_audio(0.6, 8), _audio(0.35, 9)] if case != "long_form" else [_audio(1.5, 10)]
    if case == "quantized":
        jb, tb = jb.quantize(), tb.quantize()
    with jax.default_matmul_precision("highest"):
        want = jb.transcribe_timed(audio)
    got = tb.transcribe_timed(audio)
    assert got == want
    assert ["".join(t["token"] for t in utt) for utt in got] == tb.transcribe(audio)
    assert all(len(utt) > 0 for utt in got)
    if case == "long_form":
        assert any(t["start"] >= 0.64 for t in got[0])  # the second window's tokens
