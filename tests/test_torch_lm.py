"""The port's n-gram LM (decode/lm.py) against the JAX package's: stupid-
backoff logp, sequence scores and the dense bigram matrix bit for bit on
the same corpus; an LM file written by either package loads in the other;
load_bigram_matrix's padding for model specials; and the on-device fusion
of tests/test_lm_fusion.py (a bigram matrix that prefers one token steers
the beam) token for token against JAX's beam_generate."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JTok  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode import whisper_generate as jwg  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode.lm import NGramCharLM as JLM  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.whisper import WhisperModel as JWhisper  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer as TTok  # noqa: E402
from jiao_liao_speech_recognition_torch.decode import whisper_generate as twg  # noqa: E402
from jiao_liao_speech_recognition_torch.decode.lm import NGramCharLM  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.models.whisper import WhisperModel  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

TEXTS = ["你好世界", "你好胶辽", "你好世界真好", "世界你好"] * 5


@pytest.fixture(scope="module", params=[1, 2, 3])
def lms(request):
    jt, tt = JTok.build(TEXTS), TTok.build(TEXTS)
    assert jt.vocab == tt.vocab
    return (JLM.train_from_texts(TEXTS, jt, order=request.param),
            NGramCharLM.train_from_texts(TEXTS, tt, order=request.param), tt)


def test_counts_logp_and_scores_are_bitwise_jax(lms):
    jl, tl, tok = lms
    assert tl.counts == jl.counts and tl.total == jl.total and tl.order == jl.order
    V = len(tok)
    rng = np.random.RandomState(0)
    for _ in range(200):
        ctx = [int(c) for c in rng.randint(-1, V, size=rng.randint(0, 4))]
        t = int(rng.randint(0, V))
        assert tl.logp(ctx, t) == jl.logp(ctx, t)
    for s in TEXTS[:4] + ["界世好你", "未见"]:
        ids = tok.encode(s)
        assert tl.score_sequence(ids) == jl.score_sequence(ids)
    np.testing.assert_array_equal(tl.bigram_log_matrix(), jl.bigram_log_matrix())


def test_lm_files_load_in_either_package(lms, tmp_path):
    jl, tl, tok = lms
    jl.save(tmp_path / "jax.npz")
    tl.save(tmp_path / "torch.npz")
    for got, want in ((NGramCharLM.load(tmp_path / "jax.npz"), jl),
                      (JLM.load(tmp_path / "torch.npz"), tl)):
        assert got.counts == want.counts and got.order == want.order
        assert got.vocab_size == want.vocab_size
        ids = tok.encode("你好世界")
        assert got.score_sequence(ids) == want.score_sequence(ids)


@pytest.mark.parametrize("vocab", [6, 9, 40])
def test_load_bigram_matrix_pads_like_jax(lms, tmp_path, vocab):
    jl, _, _ = lms
    jl.save(tmp_path / "lm.npz")
    want = np.asarray(jwg.load_bigram_matrix(str(tmp_path / "lm.npz"), vocab))
    got = twg.load_bigram_matrix(str(tmp_path / "lm.npz"), vocab)
    assert got.dtype == torch.float32 and got.shape == (vocab, vocab)
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_beam_fusion_biases_whisper_like_jax():
    """tests/test_lm_fusion.py's case: a matrix that massively prefers token
    7 steers the beam; the port's tokens equal JAX's with and without it."""
    kw = dict(vocab_size=32, d_model=32, encoder_layers=1, decoder_layers=1, num_heads=2,
              mlp_dim=64, max_target_positions=16, dtype="float32", use_flash_attention=False)
    jm = JWhisper(jcfg.WhisperConfig(**kw))
    mel = np.random.RandomState(0).randn(1, 80, 40).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(mel), jnp.zeros((1, 4), jnp.int32))["params"]
    tm = WhisperModel(tcfg.WhisperConfig(**kw))
    tm.load_state_dict(convert.whisper_params_to_state_dict(params))
    tm.eval()
    mat = np.full((32, 32), -10.0, np.float32)
    mat[:, 7] = 0.0
    outs = []
    for lm, w in ((None, 0.0), (mat, 5.0)):
        with jax.default_matmul_precision("highest"):
            want = jwg.beam_generate(jm, params, jnp.asarray(mel), beam_size=2, max_len=8,
                                     prompt=(1,), eot_id=2,
                                     lm_bigram=None if lm is None else jnp.asarray(lm),
                                     lm_weight=w)
        got = twg.beam_generate(tm, torch.from_numpy(mel), 2, 8, 1.0, (1,), 2,
                                None if lm is None else torch.from_numpy(lm), w)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        outs.append(got[0].numpy())
    base, fused = outs
    assert (fused == 7).mean() > 0.8
    assert not (base == fused).all()
