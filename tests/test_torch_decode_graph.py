"""The port's decode loops as the card runs them, against the JAX loops:
greedy on the shared step body (``whisper_generate.greedy_step``) for a
tiny Whisper and a tiny joint model, the beam with its state written in
place (bigram LM fusion, an Att adapter's slot caches), the device CTC
prefix beam with its frame index on the device (f32 and f64), and the int8
self-cache write's plain version against JAX's ``quantize_kv`` and cache
update. Each loop runs on two routes: eager, and chunked as a captured
graph replays it (``graphs.CapturedStep`` stood in by the CPU twin of
tests/torch_graph_twin.py, which runs the chunk on each replay, so the
last chunk runs past the end, masked on the device, as on the card). Ids
exact; beam scores within SCORE_BAR; f32 with the JAX side at HIGHEST
matmul precision. Under an empty prompt
greedy and the beam warm with a real step (step 0) before the capture.
Temperature sampling's chunked route draws what its eager route draws
from one generator seed, and both packages' samplers are held to
softmax(logits / T) by a chi-square test. Also: what cannot be captured
raises naming graph=False, and ``cli transcribe`` asks for graph
collectives."""

from types import SimpleNamespace

import numpy as np
import pytest
from scipy import stats

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.decode import ctc as jctc  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode import whisper_generate as jwg  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode.lm import NGramCharLM as JLM  # noqa: E402
from jiao_liao_speech_recognition_tpu.models import layers as jlayers  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.joint import JointCTCAttentionModel as JJoint  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.whisper import WhisperModel as JWhisper  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops import quant as jquant  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import cli  # noqa: E402
from jiao_liao_speech_recognition_torch.decode import ctc as tctc  # noqa: E402
from jiao_liao_speech_recognition_torch.decode import whisper_generate as twg  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.models.joint import JointCTCAttentionModel  # noqa: E402
from jiao_liao_speech_recognition_torch.models.whisper import WhisperModel  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import quant as tquant  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import multihost  # noqa: E402
from jiao_liao_speech_recognition_torch.parallel import tp as ttp  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import graphs  # noqa: E402
from torch_graph_twin import ReplayedOnCPU, chunked  # noqa: E402

WHISPER = dict(vocab_size=50, d_model=64, encoder_layers=2, decoder_layers=2, num_heads=4,
               mlp_dim=128, max_target_positions=24, use_flash_attention=False)
JOINT = dict(vocab_size=32, d_model=32, num_layers=2, decoder_layers=2, num_heads=2,
             mlp_dim=64, conv_channels=16, dropout=0.0, use_flash_attention=False,
             max_target_positions=32, dtype="float32")
PROMPT4 = (1, 3, 4, 5)
MAX_LEN = 13  # 12 steps: the prompt's 4 eagerly, then one chunk of 8
# the weights moved off their init so greedy rows differ; with these EOTs
# the rows end inside the chunk or never (Whisper: lengths 7, 3, 9), or in
# the eager prefix and inside the chunk (joint: 4, 0, 5)
NOISE = {"whisper": 0.2, "joint": 0.5}
GREEDY_EOT = {"whisper": 22, "joint": 16}
SCORE_BAR = 1e-4  # the beam tests' bar: summed f32 log-probs over up to 12 steps
BEAM_PROMPT, BEAM_EOT = (1, 3), 2


_JAX = {}  # each JAX reference once for both routes


def _jax_once(key, fn):
    if key not in _JAX:
        with jax.default_matmul_precision("highest"):
            _JAX[key] = [np.asarray(x) for x in fn()]
    return _JAX[key]


@pytest.fixture(params=["eager", "chunked"])
def route(request, monkeypatch):
    if request.param == "chunked":
        chunked(monkeypatch)
    return request.param


def _t(a):
    return torch.from_numpy(np.array(a))


def _noisy(params, scale, seed=5):
    noise = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * noise.randn(*x.shape)).astype(np.float32), params)


@pytest.fixture(scope="module")
def whisper():
    jm = JWhisper(jcfg.WhisperConfig(dtype="float32", **WHISPER))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 60)),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    params = _noisy(params, NOISE["whisper"])
    tm = WhisperModel(tcfg.WhisperConfig(dtype="float32", **WHISPER))
    tm.load_state_dict(convert.whisper_params_to_state_dict(params))
    tm.eval()
    mel = (np.random.RandomState(0).randn(3, 80, 60) * 0.3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        enc = jm.apply({"params": params}, jnp.asarray(mel), method=jm.encode)
    return jm, params, tm, enc, None


@pytest.fixture(scope="module")
def joint():
    jm = JJoint(jcfg.JointModelConfig(**JOINT))
    rng = np.random.RandomState(0)
    feats = rng.randn(3, 80, 64).astype(np.float32)
    flens = np.array([64, 32, 55], np.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(feats[:2]), jnp.asarray(flens[:2]),
                     jnp.zeros((2, 6), jnp.int32))["params"]
    params = _noisy(params, NOISE["joint"])
    tm = JointCTCAttentionModel(tcfg.JointModelConfig(**JOINT))
    tm.load_state_dict(convert.joint_params_to_state_dict(params))
    tm.eval()
    with jax.default_matmul_precision("highest"):
        enc, el = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(flens),
                           method=jm.encode)
    return jm, params, tm, enc, el


@pytest.mark.parametrize("family", ["whisper", "joint"])
@pytest.mark.parametrize("B", [1, 3])
def test_greedy_on_the_step_body_is_jaxs(family, B, route, request):
    """Greedy at max_len 13 with a 4-token prompt: the rows' EOTs fall in
    the eager prefix, inside the chunk or nowhere; the tokens and lengths
    are JAX's on both routes, and a chunked run counts the chunk's steps."""
    jm, params, tm, enc, el = request.getfixturevalue(family)
    rows = slice(1, 2) if B == 1 else slice(0, 3)
    enc = enc[rows]
    el = None if el is None else el[rows]
    eot = GREEDY_EOT[family]
    want, want_len = _jax_once(("greedy", family, B), lambda: jwg.greedy_from_enc(
        jm, params, enc, el, max_len=MAX_LEN, prompt=PROMPT4, eot_id=eot))
    twg.STEPS.reset()
    got, got_len = twg.greedy_from_enc(tm, _t(enc), None if el is None else _t(el), MAX_LEN,
                                       PROMPT4, eot)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    lens = got_len.tolist()
    if B == 3:  # the rows end at three different steps
        assert len(set(lens)) == 3, lens
    # the prefix's 4 steps, then the chunk's 8 unless every row ended in the prefix
    assert twg.STEPS.steps == (len(PROMPT4) if max(lens) == 0 else MAX_LEN - 1)


def _counting_steps(model, monkeypatch):
    """Count model.decode_step's calls (every decode step runs one)."""
    calls = []
    real = model.decode_step

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(model, "decode_step", counted)
    monkeypatch.setattr(ReplayedOnCPU, "calls", calls)
    return calls


@pytest.mark.parametrize("family", ["whisper", "joint"])
@pytest.mark.parametrize("loop", ["greedy", "beam"])
def test_empty_prompt_loops_are_jaxs_and_warm_with_a_step(family, loop, route, request,
                                                          monkeypatch):
    """prompt=() (the JAX loops' default) at max_len 13: greedy (3 rows) and
    the beam of 3 (2 rows) equal JAX's on both routes (beam scores within
    SCORE_BAR); on the chunked route step 0 runs as the warm-up before the
    capture, and the captured chunk starts at step 1, so its last replay
    runs 4 steps past the end, masked."""
    jm, params, tm, enc, el = request.getfixturevalue(family)
    eot = GREEDY_EOT[family]
    if loop == "greedy":
        want = _jax_once(("greedy0", family), lambda: jwg.greedy_from_enc(
            jm, params, enc, el, max_len=MAX_LEN, prompt=(), eot_id=eot))
    else:
        enc, el = enc[:2], None if el is None else el[:2]
        want = _jax_once(("beam0", family), lambda: jwg.beam_from_enc(
            jm, params, enc, el, beam_size=3, max_len=MAX_LEN, prompt=(), eot_id=eot))
    calls = _counting_steps(tm, monkeypatch)
    args = (tm, _t(enc), None if el is None else _t(el))
    if loop == "greedy":
        got = twg.greedy_from_enc(*args, MAX_LEN, (), eot)
    else:
        got = twg.beam_from_enc(*args, 3, MAX_LEN, (), eot)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if loop == "beam":
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=SCORE_BAR, rtol=0)
    if route == "chunked":
        assert [t.steps_before_capture for t in ReplayedOnCPU.made] == [1]  # step 0 first
        # step 0, then whole chunks from step 1 (the last masked past step 11)
        assert len(calls) in (1 + 8, 1 + 16)
    else:
        assert len(calls) <= MAX_LEN - 1


def test_sampling_chunked_draws_the_eager_draws(whisper, monkeypatch):
    """Temperature 1.0 at max_len 16 behind the 4-token prompt: the prompt's
    steps and the first drawn step eagerly, then chunks of 8 from step 4,
    the second one masked past step 14. From one CPU generator seed the
    chunked route gives the eager route's tokens and lengths, with the
    caller's generator handed to the capture; and a different seed gives
    other tokens (the draws are not fixed)."""
    _, _, tm, enc, _ = whisper
    max_len, eot = 16, GREEDY_EOT["whisper"]

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return twg.greedy_from_enc(tm, _t(enc), None, max_len, PROMPT4, eot, temperature=1.0,
                                   generator=g), g

    (eager, eager_len), _ = run(7)
    chunked(monkeypatch)
    calls = _counting_steps(tm, monkeypatch)
    (replayed, replayed_len), g = run(7)
    np.testing.assert_array_equal(replayed.numpy(), eager.numpy())
    np.testing.assert_array_equal(replayed_len.numpy(), eager_len.numpy())
    assert [t.generator for t in ReplayedOnCPU.made] == [g]
    assert len(calls) == 4 + 16  # the last chunk ran past the end
    (other, _), _ = run(8)
    assert not torch.equal(other, replayed)


SAMPLE_DRAWS, SAMPLE_T, CHI2_P_BAR = 20000, 0.7, 1e-3


def test_sampling_distribution_is_softmax_over_t():
    """At fixed logits (V=12) and T=0.7, 20,000 draws of the port's sampler
    (``sample_ids``, one CPU generator seed) and of jax.random.categorical
    (the JAX loop's draw, one key) each pass a chi-square test against
    softmax(logits / T) at p > CHI2_P_BAR; the port's draws fail it against
    softmax(logits), the test's power at this N."""
    # every bin expects at least 63 draws
    logits = np.random.RandomState(11).randn(12).astype(np.float32) * 0.8
    x = logits.astype(np.float64)
    want = np.exp(x / SAMPLE_T - (x / SAMPLE_T).max())
    want /= want.sum()
    ids = twg.sample_ids(_t(logits).expand(SAMPLE_DRAWS, -1), SAMPLE_T,
                         torch.Generator().manual_seed(3)).numpy()
    jids = np.asarray(jax.random.categorical(jax.random.PRNGKey(3), jnp.asarray(logits) / SAMPLE_T,
                                             shape=(SAMPLE_DRAWS,)))
    for draws in (ids, jids):
        counts = np.bincount(draws, minlength=12)
        assert stats.chisquare(counts, SAMPLE_DRAWS * want).pvalue > CHI2_P_BAR
    plain = np.exp(x - x.max())
    plain /= plain.sum()
    counts = np.bincount(ids, minlength=12)
    assert stats.chisquare(counts, SAMPLE_DRAWS * plain).pvalue < CHI2_P_BAR


@pytest.fixture(scope="module")
def whisper_att(tmp_path_factory):
    """A tiny Whisper with an Att adapter (slot caches in every block),
    adapter weights moved off their identity init, and a bigram LM."""
    ad = dict(kind="att", att_num_heads=2, att_key_dim=8, dropout=0.0)
    cfgs = [m.WhisperConfig(dtype="float32", prompt_ids=BEAM_PROMPT, eot_id=BEAM_EOT,
                            adapter=m.AdapterConfig(**ad), **WHISPER) for m in (jcfg, tcfg)]
    params = JBundle._init_params(jcfg.ExperimentConfig(model_family="whisper", whisper=cfgs[0]),
                                  seed=0)
    params = _noisy(params, 0.1, seed=1)
    tm = WhisperModel(cfgs[1])
    tm.load_state_dict(convert.whisper_params_to_state_dict(params))
    tm.eval()
    jm = JWhisper(cfgs[0])
    mel = (np.random.RandomState(3).randn(2, 80, 60) * 0.3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        enc = jm.apply({"params": params}, jnp.asarray(mel), method=jm.encode)
    lm = JLM.train([[7, 8, 7, 8, 9], [7, 9, 9, 11], [8, 11, 7]], order=2,
                   vocab_size=WHISPER["vocab_size"])
    path = tmp_path_factory.mktemp("lm") / "lm.npz"
    lm.save(path)
    return jm, params, tm, enc, str(path)


@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_beam_in_place_with_lm_and_slot_caches_is_jaxs(whisper_att, layout, route, monkeypatch):
    """Every beam (tokens exact, summed log-probs within SCORE_BAR) of the
    in-place beam against JAX's beam_from_enc, with the bigram LM fused and
    an Att adapter's slot caches gathered along the beams."""
    jm, params, tm, enc, lm_path = whisper_att
    monkeypatch.setattr(jlayers, "HEAD_MAJOR_MIN_BATCH", 1 if layout == "head_major" else 1 << 30)
    V = WHISPER["vocab_size"]
    want = _jax_once(("beam", layout), lambda: jwg.beam_from_enc(
        jm, params, enc, None, beam_size=3, max_len=MAX_LEN, prompt=BEAM_PROMPT,
        eot_id=BEAM_EOT, lm_bigram=jwg.load_bigram_matrix(lm_path, V), lm_weight=0.5))
    got = twg.beam_from_enc(tm, _t(enc), None, 3, MAX_LEN, BEAM_PROMPT, BEAM_EOT,
                            lm_bigram=twg.load_bigram_matrix(lm_path, V), lm_weight=0.5,
                            layout=layout)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=SCORE_BAR, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("B, T, V, beam, topk", [(4, 21, 9, 8, 5), (3, 13, 12, 4, 16)])
def test_ctc_device_beam_with_device_frames_is_jaxs(dtype, B, T, V, beam, topk, route):
    """The device beam with its frame index on the device against JAX's
    lax.scan beam, in f32 and (JAX with x64 on) f64; lengths T, 1 and
    ragged, so the chunked route's last chunk runs frames past every row,
    frozen."""
    rng = np.random.RandomState(B * 100 + T)
    x = (2.0 * rng.randn(B, T, V)).astype(np.float32)
    lens = rng.randint(1, T + 1, B).astype(np.int32)
    lens[0], lens[-1] = T - 2, 1
    with jax.enable_x64(dtype == "float64"):
        lp = np.asarray(jax.nn.log_softmax(jnp.asarray(x.astype(dtype)), axis=-1))
        want = _jax_once(("ctc", dtype, B), lambda: jctc.ctc_prefix_beam_search(
            jnp.asarray(lp), jnp.asarray(lens), beam_size=beam, topk_tokens=topk))
    assert lp.dtype == np.dtype(dtype)
    ids, n = tctc.ctc_prefix_beam_search(_t(lp), _t(lens), beam_size=beam, topk_tokens=topk)
    np.testing.assert_array_equal(n.numpy(), want[1])
    np.testing.assert_array_equal(ids.numpy(), want[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("index", ["ragged", "int"])
def test_int8_cache_write_plain_is_jaxs_quantize_kv_and_update(dtype, index):
    """int8_kv_write (its plain version on the CPU) against JAX's
    quantize_kv + update_cache_rows of K, V and their scales: bitwise, at
    ragged [B] positions with 0 and the cache's last row, or one int
    position, with all-zero rows among the inputs."""
    rng = np.random.RandomState(4)
    B, H, T, dh = 4, 3, 9, 64
    k = (rng.randn(B, H, 1, dh) * 3).astype(np.float32)
    v = (rng.randn(B, H, 1, dh) * 0.01).astype(np.float32)
    k[1, 2] = 0.0
    v[3] = 0.0
    if dtype == "bfloat16":  # the card's compute dtype: the same values both sides
        k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (k, v))
    pos = np.array([0, T - 1, 4, T - 1]) if index == "ragged" else 5
    caches = {"k": rng.randint(-127, 128, (B, H, T, dh)).astype(np.int8),
              "v": rng.randint(-127, 128, (B, H, T, dh)).astype(np.int8),
              "k_scale": rng.rand(B, H, T).astype(np.float32),
              "v_scale": rng.rand(B, H, T).astype(np.float32)}
    want = dict(caches)
    for name, a in (("k", k), ("v", v)):
        q, s = jquant.quantize_kv(jnp.asarray(a))
        for n, new in ((name, q), (f"{name}_scale", s)):
            want[n] = np.asarray(jlayers.update_cache_rows(jnp.asarray(want[n]), new,
                                                           jnp.asarray(pos), 2))
    tdt = getattr(torch, dtype)
    for fn in (tquant.int8_kv_write, tquant.int8_kv_write_plain):
        got = {n: _t(c) for n, c in caches.items()}
        fn(_t(k).to(tdt), _t(v).to(tdt), got, _t(pos) if index == "ragged" else pos)
        for n in want:
            np.testing.assert_array_equal(got[n].numpy(), want[n], err_msg=n)


def test_what_cannot_be_captured_raises_naming_graph_false():
    """A stand-in model group on a card-typed device: check_capturable
    (and the loops' capture rule) raise naming graph=False; on the CPU, or
    with graph=False, the loops step eagerly."""
    class StandIn:
        def all_reduce(self, t):
            return t

        def all_gather(self, t):
            return [t, t]

    model = WhisperModel(tcfg.WhisperConfig(dtype="float32", **WHISPER))
    ttp.apply_tp(model, ttp.TPGroup(0, 2, StandIn()))
    card = torch.device("cuda")
    for who in ("greedy_from_enc", "beam_from_enc", "spec_greedy_from_enc"):
        with pytest.raises(ValueError, match="graph=False"):
            ttp.check_capturable(model, card, who)
        with pytest.raises(ValueError, match=f"{who}: a stand-in model group"):
            graphs.capturing(card, True, model, who)
    assert graphs.capturing(card, False, model, "greedy_from_enc") is False
    assert graphs.capturing(torch.device("cpu"), True, model, "greedy_from_enc") is False
    assert graphs.capturing(card, True) is True  # the CTC beam has no model group


def test_cli_transcribe_asks_for_graph_collectives(monkeypatch, tmp_path):
    """`transcribe --multihost` starts its process group with graph
    collectives, as `serve` does, so a split model's loops capture."""
    seen = []
    monkeypatch.setattr(multihost, "initialize", lambda **kw: seen.append(kw))
    monkeypatch.setattr(multihost, "shutdown", lambda: None)
    monkeypatch.setattr(multihost, "is_primary", lambda: True)
    monkeypatch.setattr(cli, "_load_bundle", lambda args: None)
    wav = tmp_path / "a.wav"
    wav.write_bytes(b"")
    assert cli.main(["transcribe", str(wav), "--checkpoint", str(tmp_path),
                     "--device", "cpu", "--multihost"]) == 2
    assert seen == [{"device": "cpu", "graph_collectives": True}]


def test_greedy_step_is_the_serving_engines_step(monkeypatch):
    """One step body: the engine's _step is greedy_step at its lanes."""
    from jiao_liao_speech_recognition_torch.serve import engine

    calls = []
    eng = SimpleNamespace(model="m", _tokens="t", _pos="p", _done="d", _enc_all="e",
                          _caches="c", _P=4, max_len=9, eot=2, _always=None, _begin=None)
    monkeypatch.setattr(engine, "greedy_step", lambda *a, **k: calls.append(a))
    engine.ServingEngine._step(eng)
    assert calls == [("m", "t", "p", "d", "e", "c", None, 4, 9, 2, None, None)]
