"""The port's continuous-batching engine (serve/engine.py) and its per-row
decode step against the JAX package's and the port's offline path, on the
CPU: a tiny f32 Whisper (d=64, 1 + 2 blocks, 2 heads, V=96) made by the
JAX package and carried into the port by models/convert.py.

* decode_step with an all-equal [B] position tensor is the scalar step,
  bit for bit, in both cache layouts and with int8 self caches;
* with ragged positions its logits and the rows it writes are JAX's
  decode_step's on the same caches within F32_BAR;
* the engine's texts are the port's transcribe and the JAX engine's:
  five utterances over 2 slots, ragged mid-flight admission, the step API
  and stats, suppression per row, a quantized bundle, a 16-slot pool
  (head-major, int8 self caches), long-form chunking; the CTC family is
  refused; with timestamps each request's spans are transcribe_timed's;
* the state tensors keep their addresses through admission, dispatch and
  harvest (the card's CUDA graph replays on them)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JChar  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.whisper import WhisperModel as JWhisper  # noqa: E402
from jiao_liao_speech_recognition_tpu.serve import ServingEngine as JEngine  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import api  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.serve import ServingEngine  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

EOT = 2
PROMPT = (1, 3)
TINY = dict(vocab_size=96, d_model=64, encoder_layers=1, decoder_layers=2, num_heads=2,
            mlp_dim=128, max_source_positions=32, max_target_positions=16, prompt_ids=PROMPT,
            eot_id=EOT, use_flash_attention=False)
VOCAB = [chr(0x4E00 + i) for i in range(94)]
# f32 logits of the same step in both packages: sums reordered
F32_BAR = 1e-5


def _configs(dtype="float32", **extra):
    out = []
    for m in (jcfg, tcfg):
        cfg = m.ExperimentConfig(model_family="whisper",
                                 whisper=m.WhisperConfig(dtype=dtype, **{**TINY, **extra}))
        cfg.frontend.chunk_seconds = 0.64
        cfg.decode.max_decode_len = 12
        out.append(cfg)
    return out


def _pair(dtype="float32", **extra):
    """(JAX bundle, port bundle) on the same weights (JAX's seed-0 init)."""
    jc, tc = _configs(dtype, **extra)
    params = JBundle._init_params(jc)
    jb = JBundle(config=jc, params=params, tokenizer=JChar(VOCAB))
    tb = api.load(config=tc, device="cpu")
    tb.model.load_state_dict(convert.whisper_params_to_state_dict(params))
    tb.tokenizer = CharTokenizer(VOCAB)
    return jb, tb


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _wavs(n, seed=0, seconds=0.6):
    rng = np.random.RandomState(seed)
    return [(rng.randn(int(16000 * seconds)) * 0.1).astype(np.float32) for _ in range(n)]


def _jax_engine_texts(jb, wavs, **kw):
    with jax.default_matmul_precision("highest"):
        return JEngine(jb, **kw).transcribe(wavs)


# --- decode_step with a position tensor -------------------------------------------


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("case", ["packed", "head_major", "bf16_head_major", "int8_self",
                                  "int8_cross_only"])
def test_decode_step_equal_positions_are_the_scalar_step(pair, case):
    _, tb = pair
    model = tb.model
    if case == "bf16_head_major":
        model = _pair("bfloat16")[1].model
    if case.startswith("int8"):
        model = tb.quantize().model
    layout = "packed" if case in ("packed", "int8_cross_only") else "head_major"
    rng = np.random.RandomState(2)
    B = 3
    mel = torch.from_numpy((rng.randn(B, 80, 64) * 0.3).astype(np.float32))
    toks = torch.from_numpy(rng.randint(4, 90, (B, 4)))
    with torch.no_grad():
        enc = model.encode(mel)
        c_s = model.init_cache(B, enc, 12, layout)
        c_v = model.init_cache(B, enc, 12, layout)
        assert ("k_scale" in c_s["block_0"]["self"]) == (case == "int8_self")
        for p in range(4):
            lg_s, c_s = model.decode_step(toks[:, p:p + 1], p, enc, c_s)
            lg_v, c_v = model.decode_step(toks[:, p:p + 1], torch.full((B,), p), enc, c_v)
            assert torch.equal(lg_s, lg_v), p
        lg_0, _ = model.decode_step(toks[:, 3:4], torch.tensor(3), enc, c_v)  # 0-dim
    assert torch.equal(lg_0, lg_s)
    for a, b in zip(_leaves(c_s), _leaves(c_v)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_decode_step_ragged_positions_match_jax(pair, layout):
    jb, tb = pair
    jm = JWhisper(jb.config.whisper)
    rng = np.random.RandomState(3)
    B, pos = 4, np.array([0, 5, 2, 9])
    mel = (rng.randn(B, 80, 64) * 0.3).astype(np.float32)
    tok = rng.randint(4, 90, (B, 1)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        enc = jm.apply({"params": jb.params}, jnp.asarray(mel), method=jm.encode)
        caches = jm.apply({"params": jb.params}, B, enc, 12, layout, method=jm.init_cache)
        # earlier rows of the self caches: seeded values, the same on both sides
        caches = jax.tree_util.tree_map(np.asarray, caches)
        for blk in caches.values():
            for n in ("k", "v"):
                blk["self"][n] = (rng.randn(*blk["self"][n].shape) * 0.5).astype(np.float32)
        want, want_c = jm.apply({"params": jb.params}, jnp.asarray(tok), jnp.asarray(pos, jnp.int32),
                                enc, jax.tree_util.tree_map(jnp.asarray, caches),
                                method=jm.decode_step)
    t_caches = {b: {k: {n: torch.from_numpy(np.array(a)) for n, a in c.items()}
                    for k, c in e.items()} for b, e in caches.items()}
    with torch.no_grad():
        got, got_c = tb.model.decode_step(torch.from_numpy(tok).long(), torch.from_numpy(pos),
                                          torch.from_numpy(np.array(enc)), t_caches)
    assert np.abs(got.numpy() - np.asarray(want)).max() < F32_BAR
    for a, b in zip(_leaves(got_c), jax.tree_util.tree_leaves(
            {k: want_c[k] for k in sorted(want_c)})):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=F32_BAR, rtol=0)


# --- the engine ---------------------------------------------------------------------


@pytest.mark.parametrize("eot", [EOT, 95])
def test_engine_matches_transcribe_and_the_jax_engine(pair, eot):
    """Five utterances over 2 lanes. With EOT at 95, an id the model emits,
    the lanes finish after different numbers of steps."""
    jb, tb = pair if eot == EOT else _pair(eot_id=eot)
    wavs = _wavs(5, seed=3)
    ref = tb.transcribe(wavs)
    eng = ServingEngine(tb, slots=2, steps_per_dispatch=4, max_len=12)
    got = eng.transcribe(wavs)
    assert got == ref == _jax_engine_texts(jb, wavs, slots=2, steps_per_dispatch=4, max_len=12)
    assert len(set(got)) > 1  # the utterances decode to different texts
    if eot != EOT:
        assert len({len(t) for t in got}) > 1
    assert eng.stats.completed == 5
    assert eng.stats.dispatches >= 3  # 2 lanes cannot take 5 in one wave
    assert len(eng.stats.latencies_s) == 5
    assert eng.stats.p95_latency_s >= eng.stats.mean_latency_s >= 0.0
    assert eng._graph is None and eng.replays == 0  # the CPU steps eagerly


def test_engine_ragged_midflight_admission(pair):
    jb, tb = pair
    wavs = _wavs(2, seed=4)
    ref = tb.transcribe(wavs)
    eng = ServingEngine(tb, slots=2, steps_per_dispatch=3, max_len=12)
    r0 = eng.submit(wavs[0])
    eng._dispatch_and_harvest()  # lane 0 advances 3 tokens alone
    pos_before = int(eng._pos[0])
    r1 = eng.submit(wavs[1])  # admitted at position 0 mid-flight
    assert int(eng._pos[1]) == 0 and pos_before > 0
    texts = eng.drain()
    assert [texts[r0], texts[r1]] == ref == _jax_engine_texts(jb, wavs, slots=2,
                                                              steps_per_dispatch=3, max_len=12)


def test_engine_step_api_and_queued_waves(pair):
    _, tb = pair
    wavs = _wavs(3, seed=7)
    ref = tb.transcribe(wavs)
    eng = ServingEngine(tb, slots=2, steps_per_dispatch=16, max_len=12)
    assert eng.in_flight == 0 and eng.step() == []
    rids = [eng.submit(w, admit=False) for w in wavs]
    assert eng.in_flight == 3 and all(r is None for r in eng._slot_req)
    got = {}
    while eng.in_flight:
        for req in eng.step():
            assert req.finished_at >= req.started_at >= req.submitted_at
            assert req.text == tb.tokenizer.decode(req.ids)
            got[req.rid] = req.text
    assert [got[r] for r in rids] == ref
    assert eng.stats.dispatches == 2 and eng.stats.decode_steps == 32


def test_engine_suppresses_per_row(pair):
    """begin_suppress lands on each lane's first generated token whatever
    the other lanes' positions."""
    jb, _ = pair
    extra = dict(suppress_ids=(5, 95), begin_suppress_ids=(4, 88))  # ids the model emits
    jbs, tbs = _pair(**extra)
    wavs = _wavs(4, seed=9)
    ref = tbs.transcribe(wavs)
    eng = ServingEngine(tbs, slots=2, steps_per_dispatch=3, max_len=12)
    got = eng.transcribe(wavs)
    assert got == ref == _jax_engine_texts(jbs, wavs, slots=2, steps_per_dispatch=3, max_len=12)
    assert got != _jax_engine_texts(jb, wavs, slots=2, steps_per_dispatch=3, max_len=12)


def test_engine_quantized_bundle(pair):
    jb, tb = pair
    wavs = _wavs(3, seed=5)
    qb = tb.quantize()
    eng = ServingEngine(qb, slots=2, steps_per_dispatch=4, max_len=12)
    assert "k_scale" in eng._caches["block_0"]["cross"]
    assert eng.transcribe(wavs) == qb.transcribe(wavs) == _jax_engine_texts(
        jb.quantize(), wavs, slots=2, steps_per_dispatch=4, max_len=12)


@pytest.mark.parametrize("quantized", [False, True])
def test_engine_sixteen_slots_head_major_pool(pair, quantized):
    """At 16 slots the pool is head-major (int8 self caches for a quantized
    bundle), as the JAX engine's; 20 utterances recycle lanes. The int8
    self caches are read with K9-int8's rounding points, which the JAX
    package takes only on its TPU route (the port's offline path is held
    to that route by tests/test_torch_quant.py), so the quantized pool is
    held to the port's transcribe."""
    jb, tb = pair
    if quantized:
        tb = tb.quantize()
    wavs = _wavs(20, seed=12)
    eng = ServingEngine(tb, slots=16, steps_per_dispatch=5, max_len=12)
    self_cache = eng._caches["block_1"]["self"]
    assert self_cache["k"].dim() == 4 and ("k_scale" in self_cache) == quantized
    got = eng.transcribe(wavs)
    assert got == tb.transcribe(wavs)
    if not quantized:
        assert got == _jax_engine_texts(jb, wavs, slots=16, steps_per_dispatch=5, max_len=12)


def test_engine_long_form_chunking(pair):
    jb, tb = pair
    rng = np.random.RandomState(6)
    long_wav = (rng.randn(int(16000 * 1.5)) * 0.1).astype(np.float32)  # 3 windows
    short = (rng.randn(int(16000 * 0.4)) * 0.1).astype(np.float32)
    eng = ServingEngine(tb, slots=2, steps_per_dispatch=4, max_len=12)
    got = eng.transcribe([long_wav, short])
    assert got == tb.transcribe([long_wav, short]) == _jax_engine_texts(
        jb, [long_wav, short], slots=2, steps_per_dispatch=4, max_len=12)
    assert eng.stats.completed == 4  # 3 windows + 1


def test_engine_refuses_the_ctc_family():
    cfg = tcfg.ExperimentConfig(model_family="ctc")
    cfg.ctc_model = dataclasses.replace(cfg.ctc_model, d_model=64, num_layers=1, num_heads=2,
                                        mlp_dim=128, vocab_size=8, conv_channels=16)
    with pytest.raises(ValueError, match="CTC"):
        ServingEngine(api.load(config=cfg, device="cpu"))


def test_engine_timestamps_are_transcribe_timed(pair):
    _, tb = pair
    wavs = _wavs(3, seed=5)
    eng = ServingEngine(tb, slots=2, steps_per_dispatch=4, max_len=12, timestamps=True)
    rids = [eng.submit(w) for w in wavs]
    got = {}
    while eng.in_flight:
        for req in eng.step():
            got[req.rid] = req
    for rid, wav in zip(rids, wavs):
        req = got[rid]
        assert req.timed == tb.transcribe_timed(wav)[0]
        assert "".join(t["token"] for t in req.timed) == req.text
        assert len(req.timed) == len(req.ids) > 0


def test_engine_state_keeps_its_addresses(pair):
    """Admission, dispatch and harvest write the state in place: every
    tensor the card's graph recorded keeps its data_ptr."""
    _, tb = pair
    eng = ServingEngine(tb.quantize(), slots=2, steps_per_dispatch=3, max_len=12)
    state = eng._state()
    ptrs = [t.data_ptr() for t in state]
    assert len(state) == 4 + 2 * (4 + 2)  # 2 blocks: int8 cross (4), bf16 self (2)
    eng.submit(_wavs(1, seed=1)[0])
    after_admit = [t.data_ptr() for t in eng._state()]
    eng.transcribe(_wavs(3, seed=2))
    assert after_admit == [t.data_ptr() for t in eng._state()] == ptrs
    assert all(a is b for a, b in zip(eng._state(), state))


def test_row_suppression_equals_the_scalar_form():
    from jiao_liao_speech_recognition_torch.decode import whisper_generate as twg

    always, begin = twg.suppression_masks(10, (1, 7), (3, 4))
    logits = torch.from_numpy(np.random.RandomState(0).randn(3, 10).astype(np.float32))
    pos = torch.tensor([0, 1, 5])
    rows = twg.apply_suppression_rows(logits, pos, 2, always, begin)
    for b in range(3):
        want = twg.apply_suppression(logits[b:b + 1], int(pos[b]), 2, always, begin)
        assert torch.equal(rows[b:b + 1], want)


@pytest.mark.parametrize("kind", ["wf", "att"])
def test_engine_serves_an_adapted_bundle(kind):
    """A WF- or Att-adapted Whisper behind the engine: the Att adapter's
    slot caches are lanes of the pool like the self caches; the texts equal
    the bundle's transcribe and the JAX engine's on the same weights (the
    adapters moved off their identity init)."""
    ad = dict(kind=kind, wf_rank=2, att_num_heads=2, att_key_dim=8, dropout=0.0)
    jc, tc = _configs()
    jc.whisper.adapter, tc.whisper.adapter = jcfg.AdapterConfig(**ad), tcfg.AdapterConfig(**ad)
    params = JBundle._init_params(jc)
    noise = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (np.asarray(v) + 0.02 * noise.randn(*v.shape)).astype(np.float32)
        if any("adapter_" in str(getattr(k, "key", "")) for k in path) else np.asarray(v),
        params)
    jb = JBundle(config=jc, params=params, tokenizer=JChar(VOCAB))
    tb = api.load(config=tc, device="cpu")
    tb.model.load_state_dict(convert.whisper_params_to_state_dict(params))
    tb.tokenizer = CharTokenizer(VOCAB)
    t = np.arange(int(16000 * 0.6)) / 16000
    wavs = [(0.5 * np.sin(2 * np.pi * 300 * (i + 1) * t) + 0.1 * w).astype(np.float32)
            for i, w in enumerate(_wavs(5, seed=3))]  # distinct tones under the noise
    eng = ServingEngine(tb, slots=2, steps_per_dispatch=4, max_len=12)
    if kind == "att":
        slot = eng._caches["block_0"]["slots"]["post_attn"]["k"]
        assert tuple(slot.shape) == (2, 12, 16)
    got = eng.transcribe(wavs)
    assert got == tb.transcribe(wavs) == _jax_engine_texts(jb, wavs, slots=2,
                                                           steps_per_dispatch=4, max_len=12)
    assert len(set(got)) > 1
