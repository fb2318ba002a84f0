"""The port's CTC-draft speculative greedy (decode/speculative.py) against
the JAX package's, on tests/test_speculative.py's three draft regimes (the
random-init CTC head's draft, a perfect draft, an empty one) and through
the bundle: the same tokens, lengths and verification passes from the same
weights (carried over by the bridge) and the same seeded inputs, f32, the
JAX side at HIGHEST matmul precision; and the tokens equal greedy's. Each
case runs on two routes: eager, and chunked as the card's captured passes
replay (tests/torch_graph_twin.py: the first pass eagerly as the warm-up,
then one captured pass a replay while another is needed)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.decode import speculative as jsp  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode.joint_generate import joint_greedy as jgreedy  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode.whisper_generate import greedy_from_enc as jgfe  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.joint import JointCTCAttentionModel as JJoint  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.decode import speculative as tsp  # noqa: E402
from jiao_liao_speech_recognition_torch.decode.joint_generate import joint_greedy  # noqa: E402
from jiao_liao_speech_recognition_torch.decode.whisper_generate import greedy_from_enc  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.models.joint import JointCTCAttentionModel  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402
from torch_graph_twin import ReplayedOnCPU, chunked  # noqa: E402

MAX_LEN = 16
TINY = dict(vocab_size=32, d_model=32, num_layers=2, decoder_layers=2, num_heads=2, mlp_dim=64,
            conv_channels=16, dropout=0.0, dtype="float32", use_flash_attention=False,
            max_target_positions=32)


@pytest.fixture(params=["eager", "chunked"])
def route(request, monkeypatch):
    if request.param == "chunked":
        chunked(monkeypatch)
    return request.param


def _captured_once_if_needed(route, passes):
    """On the chunked route one pass is captured, and only when the first
    pass left a row to verify."""
    if route == "chunked":
        assert len(ReplayedOnCPU.made) == int(passes > 1)
        assert all(t.steps_before_capture == 0 for t in ReplayedOnCPU.made)


def setup(B=3, T=64, seed=0):
    """tests/test_speculative.py's setup, plus the port model on its params."""
    jm = JJoint(jcfg.JointModelConfig(**TINY))
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, 80, T).astype(np.float32)
    flens = np.array([T, T // 2, T][:B], np.int32)
    toks = jnp.asarray(rng.randint(2, 32, (B, 6)), jnp.int32).at[:, 0].set(0)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(feats), jnp.asarray(flens),
                     toks)["params"]
    tm = JointCTCAttentionModel(tcfg.JointModelConfig(**TINY))
    tm.load_state_dict(convert.joint_params_to_state_dict(params))
    return jm, params, tm.eval(), feats, flens


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _texts(gen, lens):
    return [tuple(int(t) for t in row[: int(n)]) for row, n in zip(np.asarray(gen), np.asarray(lens))]


def _encs(jm, params, tm, feats, flens):
    with jax.default_matmul_precision("highest"):
        enc, el = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(flens),
                           method=jm.encode)
    return enc, el, torch.from_numpy(np.array(enc)), torch.from_numpy(np.array(el))


@pytest.mark.parametrize("seed", [0, 3])
def test_spec_matches_jax_and_greedy_with_random_ctc_draft(seed, route):
    jm, params, tm, feats, flens = setup(seed=seed)
    with jax.default_matmul_precision("highest"):
        want = jsp.joint_spec_greedy(jm, params, jnp.asarray(feats), jnp.asarray(flens),
                                     max_len=MAX_LEN, return_passes=True)
    got = tsp.joint_spec_greedy(tm, torch.from_numpy(feats), torch.from_numpy(flens),
                                max_len=MAX_LEN, return_passes=True)
    _captured_once_if_needed(route, got[2])
    _equal(got[:2], want[:2])
    assert got[2] == int(want[2]) and 1 <= got[2] <= MAX_LEN - 1
    g = joint_greedy(tm, torch.from_numpy(feats), torch.from_numpy(flens), max_len=MAX_LEN)
    assert _texts(*got[:2]) == _texts(*g)


def test_perfect_draft_verifies_in_one_pass(route):
    jm, params, tm, feats, flens = setup(seed=1)
    enc, el, tenc, tel = _encs(jm, params, tm, feats, flens)
    with jax.default_matmul_precision("highest"):
        gj, lj = jgfe(jm, params, enc, el, max_len=MAX_LEN, prompt=(0,), eot_id=0)
        want = jsp.spec_greedy_from_enc(jm, params, enc, el, gj, lj, max_len=MAX_LEN,
                                        return_passes=True)
    gen_g, len_g = greedy_from_enc(tm, tenc, tel, MAX_LEN, (0,), 0)
    _equal((gen_g, len_g), (gj, lj))
    ReplayedOnCPU.made = []
    got = tsp.spec_greedy_from_enc(tm, tenc, tel, gen_g, len_g, max_len=MAX_LEN,
                                   return_passes=True)
    _captured_once_if_needed(route, got[2])
    _equal(got[:2], want[:2])
    assert got[2] == int(want[2]) == 1
    assert _texts(*got[:2]) == _texts(gen_g, len_g)
    for row, n in zip(got[0].numpy(), got[1].numpy()):
        assert (row[int(n):] == 0).all()  # the padded tail is canonical eos


def test_empty_draft_degenerates_to_greedy(route):
    jm, params, tm, feats, flens = setup(seed=2)
    enc, el, tenc, tel = _encs(jm, params, tm, feats, flens)
    B = feats.shape[0]
    with jax.default_matmul_precision("highest"):
        want = jsp.spec_greedy_from_enc(jm, params, enc, el, jnp.zeros((B, 1), jnp.int32),
                                        jnp.zeros((B,), jnp.int32), max_len=MAX_LEN,
                                        return_passes=True)
        gj = jgreedy(jm, params, jnp.asarray(feats), jnp.asarray(flens), max_len=MAX_LEN)
    got = tsp.spec_greedy_from_enc(tm, tenc, tel, torch.zeros(B, 1, dtype=torch.int32),
                                   torch.zeros(B, dtype=torch.int32), max_len=MAX_LEN,
                                   return_passes=True)
    _captured_once_if_needed(route, got[2])
    _equal(got[:2], want[:2])
    assert got[2] == int(want[2])
    assert _texts(*got[:2]) == _texts(*gj)
    n = int(np.asarray(gj[1]).max())
    assert got[2] == n + 1 or got[2] == MAX_LEN - 1  # one frontier token a pass


def test_bundle_spec_greedy_strategy_equals_greedy(route):
    from jiao_liao_speech_recognition_torch import api

    cfg = tcfg.ExperimentConfig(model_family="joint", joint=tcfg.JointModelConfig(**TINY))
    cfg.decode = tcfg.DecodeConfig(strategy="greedy", max_decode_len=MAX_LEN)
    cfg.frontend.chunk_seconds = 1.0
    tb = api.load(config=cfg, device="cpu")
    audio = [np.random.RandomState(3).randn(n).astype(np.float32) * 0.1 for n in (16000, 9000)]
    greedy = tb.transcribe(audio)
    cfg.decode.strategy = "spec_greedy"
    assert tb.transcribe(audio) == greedy
