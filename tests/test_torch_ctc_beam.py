"""The port's CTC prefix beam search against the JAX package's
``decode/ctc.py``: the device beam's ids and lengths (random rows, forced
exact ties), both searchers against an exhaustive path sum, the host
searcher bit for bit with and without a fused n-gram LM (the same .npz read
by each package), ``ctc_topk_posteriors`` bit for bit in both regimes
(dtypes, values, ids, tie order), the C++ engine built from
``native/beam.cpp`` by ``utils/native_ext.py`` against JAX's host searcher
(exact regime, threads, pruning), and ``ModelBundle.transcribe`` with
``beam`` (with and without an LM) and ``beam_device`` on a tiny CTC model
carried over by the weight bridge. Seeded numpy inputs; every comparison
but the likelihood bar and the masked logsumexp (libm ulps) is exact."""

import itertools
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JTok  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode import ctc as jctc  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode.lm import NGramCharLM as JLM  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.ctc_model import CTCEncoderModel as JModel  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops.ctc_loss import ctc_loss as jctc_loss  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer as TTok  # noqa: E402
from jiao_liao_speech_recognition_torch.decode import ctc as tctc  # noqa: E402
from jiao_liao_speech_recognition_torch.decode.lm import NGramCharLM  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle  # noqa: E402
from jiao_liao_speech_recognition_torch.models.ctc_model import CTCEncoderModel  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import native_ext  # noqa: E402

needs_cxx = pytest.mark.skipif(shutil.which("g++") is None and shutil.which("c++") is None,
                               reason="no C++ compiler on the PATH to build native/beam.cpp")
# tests/test_decode.py's bar: two searchers may part where f32 scores tie
# under pruning; their winners' CTC log-likelihoods stay within this
NLL_BAR = 0.3


def _log_probs(rng, B, T, V, scale=1.0):
    return np.asarray(jax.nn.log_softmax(jnp.asarray(scale * rng.randn(B, T, V)
                                                     .astype(np.float32)), axis=-1))


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_prefixes(a, b):
    (ia, la), (ib, lb) = (tuple(map(np.asarray, x)) for x in (a, b))
    np.testing.assert_array_equal(la, lb)
    for r in range(len(la)):
        np.testing.assert_array_equal(ia[r, :la[r]], ib[r, :lb[r]], err_msg=f"row {r}")


# ------------------------------------------------------------- device beam

DEVICE_CASES = [  # B, T, V, beam, topk_tokens
    (2, 10, 5, 1, 4), (3, 16, 7, 4, 6), (5, 24, 12, 8, 16), (4, 20, 9, 8, 4),
    (2, 12, 6, 4, 16), (5, 18, 11, 1, 8), (3, 24, 12, 4, 10), (4, 14, 5, 8, 5),
]


@pytest.mark.parametrize("B, T, V, beam, topk", DEVICE_CASES)
@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_device_beam_ids_and_lengths_are_jaxs(B, T, V, beam, topk, scale):
    rng = np.random.RandomState(B * 1000 + T * 10 + V + int(scale))
    lp = _log_probs(rng, B, T, V, scale)
    lens = rng.randint(1, T + 1, B).astype(np.int32)
    lens[0], lens[-1] = T, 1
    want = jctc.ctc_prefix_beam_search(jnp.asarray(lp), jnp.asarray(lens), beam_size=beam,
                                       topk_tokens=topk)
    ids, n = tctc.ctc_prefix_beam_search(_t(lp), _t(lens), beam_size=beam, topk_tokens=topk)
    assert ids.dtype == n.dtype == torch.int32 and ids.shape == (B, T)
    np.testing.assert_array_equal(n.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("beam", [4, 8])
def test_device_beam_with_forced_exact_ties_is_jaxs(beam):
    """Tokens with equal log-probs, repeated frames and uniform frames:
    candidates tie exactly, and lax.top_k's order (the lowest index first)
    decides which prefixes go on."""
    rng = np.random.RandomState(11)
    B, T, V = 4, 16, 8
    x = rng.randn(B, T, V).astype(np.float32)
    x[:, :, 3] = x[:, :, 5]  # two tokens tied in every frame
    x[:, 4:8] = x[:, 0:1]  # repeated frames
    x[1] = 0.0  # uniform rows: every extension ties
    x[2, :, 1:] = x[2, :, 1:2]  # every non-blank token tied
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))
    lens = np.asarray([16, 16, 9, 1], np.int32)
    want = jctc.ctc_prefix_beam_search(jnp.asarray(lp), jnp.asarray(lens), beam_size=beam,
                                       topk_tokens=6)
    got = tctc.ctc_prefix_beam_search(_t(lp), _t(lens), beam_size=beam, topk_tokens=6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_device_beam_in_f64_is_the_host_searcher_on_flat_rows():
    """On flat rows over many frames, f32 scores meet within rounding and an
    f32 beam may part from the host searcher, which sums in f64; the same
    beam run on f64 log-probs gives the host searcher's prefixes."""
    rng = np.random.RandomState(2)
    lp = np.asarray(torch.log_softmax(torch.from_numpy(
        (0.05 * rng.randn(3, 400, 500)).astype(np.float32)), -1))
    lens = np.full((3,), 400, np.int32)
    want = tctc.ctc_prefix_beam_search_host(lp, lens, 8, topk_tokens=16)
    got = tctc.ctc_prefix_beam_search(_t(lp).double(), _t(lens), 8, topk_tokens=16)
    _same_prefixes([x.numpy() for x in got], want)
    f32 = [x.numpy() for x in tctc.ctc_prefix_beam_search(_t(lp), _t(lens), 8, topk_tokens=16)]
    assert not np.array_equal(f32[0][2], want[0][2])  # the f32 beam parts on row 2


def test_masked_logsumexp_and_top_k_order_are_jaxs():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 12).astype(np.float32)
    x[:, 4] = x[:, 7] = x[:, 9]
    x[0, :6] = -1e30
    mask = rng.rand(3, 12, 12) < 0.3
    want = np.asarray(jctc._masked_logsumexp(jnp.asarray(x), jnp.asarray(mask)))
    # exp and log of two libraries: a few f32 ulps apart at most
    np.testing.assert_allclose(tctc._masked_logsumexp(_t(x), _t(mask)).numpy(), want,
                               rtol=1e-6, atol=0)
    for k in (1, 5, 9, 12):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = tctc.top_k_exact(_t(x), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


# -------------------------------------------------- the exhaustive oracle


def _collapse(path, blank=0):
    out, prev = [], None
    for t in path:
        if t != blank and t != prev:
            out.append(t)
        prev = t
    return out


def _exhaustive_best(lp):
    """tests/test_decode.py's oracle: every alignment path summed by its
    collapsed prefix; the best prefix."""
    T, V = lp.shape
    scores = {}
    for path in itertools.product(range(V), repeat=T):
        key = tuple(_collapse(path))
        scores[key] = np.logaddexp(scores.get(key, -np.inf), sum(lp[t, path[t]] for t in range(T)))
    return max(scores.items(), key=lambda kv: kv[1])[0]


@pytest.mark.parametrize("searcher", ["device", "host"])
def test_searchers_match_the_exhaustive_oracle(searcher):
    rng = np.random.RandomState(5)
    for _ in range(5):
        lp = _log_probs(rng, 1, 4, 3, scale=3.0)
        if searcher == "device":
            ids, n = (x.numpy() for x in tctc.ctc_prefix_beam_search(
                _t(lp), _t([4]), beam_size=32, topk_tokens=3))
        else:
            ids, n = tctc.ctc_prefix_beam_search_host(lp, np.array([4]), beam_size=32,
                                                      topk_tokens=3)
        assert tuple(ids[0][: int(n[0])]) == _exhaustive_best(lp[0])


def test_host_and_device_winners_have_near_equal_likelihood():
    """tests/test_decode.py::test_host_beam_matches_device_beam on the port:
    flat rows, where pruning order under ties may part the two."""
    rng = np.random.RandomState(3)
    for _ in range(5):
        lp = _log_probs(rng, 2, 10, 5)
        lens = np.array([10, 7], np.int32)
        d = [x.numpy() for x in tctc.ctc_prefix_beam_search(_t(lp), _t(lens), 8, topk_tokens=4)]
        h = tctc.ctc_prefix_beam_search_host(lp, lens, 8, topk_tokens=4)

        def nll(ids, n):
            S = max(int(n.max()), 1)
            return np.asarray(jctc_loss(jnp.asarray(lp), jnp.asarray(lens),
                                        jnp.asarray(ids[:, :S]), jnp.asarray(n)))

        assert np.abs(nll(*d) - nll(*h)).max() < NLL_BAR


# ----------------------------------------------------------- host searcher


@pytest.fixture(scope="module")
def lm_pair(tmp_path_factory):
    """One seeded trigram LM written by the JAX package, read by each."""
    path = tmp_path_factory.mktemp("lm") / "lm.npz"
    rng = np.random.RandomState(8)
    JLM.train([list(rng.randint(1, 6, rng.randint(2, 9))) for _ in range(40)], order=3,
              vocab_size=9).save(path)
    return JLM.load(path), NGramCharLM.load(path)


@pytest.mark.parametrize("fused", [None, 0.0, 0.5, 2.0])
def test_host_searcher_is_jaxs_bit_for_bit(lm_pair, fused):
    rng = np.random.RandomState(9)
    lp = _log_probs(rng, 4, 22, 9, scale=1.5)
    lens = np.asarray([22, 15, 1, 22], np.int32)
    jlm, tlm = lm_pair if fused is not None else (None, None)
    w = fused or 0.0
    want = jctc.ctc_prefix_beam_search_host(lp, lens, 6, topk_tokens=5, lm=jlm, lm_weight=w)
    got = tctc.ctc_prefix_beam_search_host(lp, lens, 6, topk_tokens=5, lm=tlm, lm_weight=w)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    if fused == 2.0:  # the LM moved something, so the fusion is live
        plain = tctc.ctc_prefix_beam_search_host(lp, lens, 6, topk_tokens=5)
        assert not np.array_equal(plain[0], got[0])


# ------------------------------------------------------ top-k posteriors


@pytest.mark.parametrize("V, k", [(9, 8), (9, 9), (40, 7), (40, 16)])
def test_topk_posteriors_are_jaxs_bit_for_bit(V, k):
    rng = np.random.RandomState(V + k)
    x = rng.randn(3, 11, V).astype(np.float32)
    x[:, :, 2] = x[:, :, 6]  # ties, inside and across the cut
    x[0, 3, :] = 0.25
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))
    want = [np.asarray(a) for a in jctc.ctc_topk_posteriors(jnp.asarray(lp), k)]
    got = [a.numpy() for a in tctc.ctc_topk_posteriors(_t(lp), k)]
    for name, g, w in zip(("values", "ids", "blank"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(np.ascontiguousarray(g).view(np.uint8),
                                      np.ascontiguousarray(w).view(np.uint8), err_msg=name)
    assert got[0].dtype == (np.float32 if k >= V - 1 else np.float16)
    assert got[1].dtype == (np.int32 if k >= V - 1 else np.int16)


# ---------------------------------------------------------- the C++ engine


def _peaked(rng, B, T, V, peaked):
    x = rng.randn(B, T, V).astype(np.float32) * (1.0 + 3.0 * peaked)
    x = x - x.max(axis=-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(axis=-1, keepdims=True))).astype(np.float32)


@needs_cxx
@pytest.mark.parametrize("beam", [1, 4, 8])
def test_native_engine_equals_jaxs_host_searcher_exactly(beam):
    rng = np.random.RandomState(beam)
    B, T, V = 5, 24, 12
    lp = _peaked(rng, B, T, V, 0.0)
    lens = np.array([24, 20, 24, 7, 1], np.int32)
    want = jctc.ctc_prefix_beam_search_host(lp, lens, beam_size=beam, topk_tokens=V - 1)
    got = tctc.ctc_prefix_beam_search_native(_t(lp), _t(lens), beam_size=beam,
                                             topk_tokens=V - 1)
    _same_prefixes(got, want)
    assert native_ext.native_available("beam")


@needs_cxx
def test_native_engine_is_deterministic_across_threads():
    rng = np.random.RandomState(1)
    lp = _peaked(rng, 16, 40, 30, 0.0)
    lens = np.full((16,), 40, np.int32)
    a = tctc.ctc_prefix_beam_search_native(lp, lens, beam_size=8, n_threads=1)
    with pytest.raises(ValueError, match="shapes"):  # checked before any pointer is passed
        native_ext.load_beam().search(lp[..., :4], lp[:, :-1, :4], lp[..., 0], lens, 8)
    for n in (0, 3, 8):
        b = tctc.ctc_prefix_beam_search_native(lp, lens, beam_size=8, n_threads=n)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@needs_cxx
def test_native_pruning_is_exact_on_peaked_blank_dominated_rows():
    """tests/test_beam_native.py's cases: prune_logp < 0 returns the exact
    result on peaked rows with half the frames blank-dominated; 0 is a
    no-op; a beam of one is greedy there."""
    rng = np.random.RandomState(6)
    B, T, V = 6, 32, 16
    lp = _peaked(rng, B, T, V, 4.0)
    lp[:, ::2, 0] = -0.01
    lp[:, ::2, 1:] = np.log(np.maximum(1.0 - np.exp(-0.01), 1e-9) / (V - 1))
    lens = np.full((B,), T, np.int32)
    exact = tctc.ctc_prefix_beam_search_native(lp, lens, beam_size=8)
    for prune in (-10.0, 0.0):
        got = tctc.ctc_prefix_beam_search_native(lp, lens, beam_size=8, prune_logp=prune)
        np.testing.assert_array_equal(exact[0], got[0])
        np.testing.assert_array_equal(exact[1], got[1])
    g_ids, g_len = (x.numpy() for x in tctc.ctc_greedy_decode(_t(lp), _t(lens)))
    n_ids, n_len = tctc.ctc_prefix_beam_search_native(lp, lens, beam_size=1)
    _same_prefixes((n_ids, n_len), (g_ids, g_len))


@needs_cxx
def test_native_build_failure_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "native"
    bad.mkdir()
    (bad / "beam.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native_ext, "NATIVE_DIR", bad)
    monkeypatch.setattr(native_ext, "BUILD_DIR", tmp_path / "build")
    assert not native_ext.native_available("beam")
    with pytest.raises(RuntimeError, match="beam.cpp"):
        native_ext.build_native("beam")
    monkeypatch.setattr(native_ext.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_ext.build_native("beam")


# ------------------------------------------------------------------ bundle

BUNDLE_MODEL = dict(d_model=64, num_layers=2, num_heads=4, mlp_dim=128, conv_channels=32,
                    vocab_size=17, dtype="float32", use_flash_attention=False)


@pytest.fixture(scope="module")
def bundles():
    """A tiny f32 CTC model (V=17, so k = V - 1 at beam_topk 16 and JAX's
    native and host routes agree) on both sides, 2 s chunks."""
    jexp = jcfg.ExperimentConfig(frontend=jcfg.FrontendConfig(chunk_seconds=2.0),
                                 ctc_model=jcfg.CTCModelConfig(**BUNDLE_MODEL))
    texp = tcfg.ExperimentConfig(frontend=tcfg.FrontendConfig(chunk_seconds=2.0),
                                 ctc_model=tcfg.CTCModelConfig(**BUNDLE_MODEL))
    params = JModel(jexp.ctc_model).init(jax.random.PRNGKey(3),
                                         jnp.zeros((1, 80, 200), jnp.float32))["params"]
    # a scaled head: peakier, more decisive rows than the random init's
    params = jax.tree_util.tree_map(np.asarray, params)
    params["ctc_head"]["kernel"] = params["ctc_head"]["kernel"] * 8.0
    vocab = [chr(0x4E00 + i) for i in range(BUNDLE_MODEL["vocab_size"] - 2)]
    model = CTCEncoderModel(texp.ctc_model)
    model.load_state_dict(convert.params_to_state_dict(params))
    rng = np.random.RandomState(12)
    audio = [(0.1 * rng.randn(int(16000 * s))).astype(np.float32) for s in (1.5, 3.3, 0.4)]
    return (JBundle(config=jexp, params=params, tokenizer=JTok(vocab)),
            ModelBundle(texp, model.eval(), TTok(vocab)), audio)


@pytest.mark.parametrize("strategy, lm_weight", [("beam", 0.0), ("beam", 0.8),
                                                 ("beam_device", 0.0)])
def test_bundle_ctc_beam_gives_the_jax_bundles_texts(bundles, tmp_path, strategy, lm_weight):
    jb, tb, audio = bundles
    lm_path = ""
    if lm_weight:
        lm_path = str(tmp_path / "lm.npz")
        JLM.train_from_texts(["一二三", "二三四五", "三一"], jb.tokenizer, order=2).save(lm_path)
    kw = dict(strategy=strategy, beam_size=4, lm_path=lm_path, lm_weight=lm_weight)
    with jax.default_matmul_precision("highest"):
        want = jb.transcribe(audio, decode_cfg=jcfg.DecodeConfig(**kw))
    got = tb.transcribe(audio, decode_cfg=tcfg.DecodeConfig(**kw))
    assert got == want and len(got) == 3
    assert tb.transcribe(audio, decode_cfg=tcfg.DecodeConfig(**kw)) == got
