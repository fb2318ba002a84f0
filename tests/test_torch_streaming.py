"""The port's streaming CTC transcription (serve/streaming.py) on the CPU,
against itself and against the JAX package's, both bundles carrying one
seed's JAX params (models/convert.params_to_state_dict):

* the JAX tests' cases in the port: finish() over one window equals the
  offline transcribe; chunk-size invariance; commit bookkeeping with a
  fake window step (four geometries); trailing silence; api.stream; pool
  equals single streams with the device ring on and off; the backlog
  drained by finish(); a reused ring row leaks nothing; the slot limit;
  the validation messages;
* port against JAX on the same audio (f32, JAX at HIGHEST precision):
  committed tokens, spans, text, preview, committed frames and
  trailing_silence after every feed, for StreamingTranscriber and for
  StreamingPool (ring on and off), and per-window log-probs within F32_BAR;
* each ring row equals the window the host would build, and the ring's
  buffers keep their addresses (a card replays a CUDA graph on them);
* the joint family's CTC branch (a WF-adapted joint model, f32): the
  transcriber and the pool against JAX's after every feed or step, and
  finish() over one window equal to the offline ctc_greedy text, the JAX
  bundle's included."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JChar  # noqa: E402
from jiao_liao_speech_recognition_tpu.frontend import features as jfeatures  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.ctc_model import CTCEncoderModel as JModel  # noqa: E402
from jiao_liao_speech_recognition_tpu.serve import streaming as jstreaming  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import api  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend import features  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert  # noqa: E402
from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle  # noqa: E402
from jiao_liao_speech_recognition_torch.serve.streaming import (  # noqa: E402
    StreamingConfig,
    StreamingPool,
    StreamingTranscriber,
)
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

SR = 16000
ALIGN = 640  # hop_length 160 * subsample 4
VOCAB = [chr(0x4E00 + i) for i in range(6)]
# f32 log-probs of one window in both packages: sums reordered
F32_BAR = 1e-5
SLIDING = StreamingConfig(window_seconds=1.28, hop_seconds=0.32, lookahead_seconds=0.16)


def _pair(dtype="bfloat16", chunk=2.56):
    """(JAX bundle, port bundle) on the same weights (JAX's seed-0 init)."""
    out = []
    for m in (jcfg, tcfg):
        cfg = m.ExperimentConfig(model_family="ctc", ctc_model=m.CTCModelConfig(
            vocab_size=8, d_model=32, num_layers=2, num_heads=2, mlp_dim=64, conv_channels=16,
            use_flash_attention=False, dropout=0.0, dtype=dtype))
        cfg.frontend.chunk_seconds = chunk  # == the streaming window for exactness
        out.append(cfg)
    params = JBundle._init_params(out[0])
    jb = JBundle(config=out[0], params=params, tokenizer=JChar(VOCAB))
    tb = api.load(config=out[1], device="cpu")
    tb.model.load_state_dict(convert.params_to_state_dict(params))
    tb.tokenizer = CharTokenizer(VOCAB)
    return jb, tb


@pytest.fixture(scope="module")
def bf16():
    return _pair()[1]


@pytest.fixture(scope="module")
def f32():
    return _pair("float32")


def _audio(seconds, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(SR * seconds)) * 0.1).astype(np.float32)


# --- the JAX tests' cases in the port -----------------------------------------


def test_finish_matches_offline_single_window(bf16):
    audio = _audio(1.28)
    offline = bf16.transcribe(audio)[0]
    st = StreamingTranscriber(bf16, StreamingConfig(2.56, 2.56, 0.0))
    st.feed(audio)
    res = st.finish()
    assert res.is_final and res.preview == ""
    assert res.text == offline


def test_chunk_size_invariance(bf16):
    audio = _audio(3.2, seed=1)

    def run(chunks):
        st = StreamingTranscriber(bf16, SLIDING)
        partials = []
        for c in chunks:
            partials.append(st.feed(c).text)
            # committed text only grows (it is final by contract)
            assert partials[-1].startswith(partials[-2] if len(partials) > 1 else "")
        return st._tokens, st.finish().text, partials[-1]

    one_tokens, one_text, _ = run([audio])
    cuts = np.sort(np.random.RandomState(7).randint(1, len(audio), size=9))
    many_tokens, many_text, many_partial = run(np.split(audio, cuts))
    assert one_tokens == many_tokens
    assert one_text == many_text
    assert many_text.startswith(many_partial)


def _fake_step(wav, nframes):
    """A window step whose frame id is round(1000 * the frame's first
    sample): the test writes the global frame index into the audio, so any
    window or offset fault shows as a wrong or missing token."""
    n = int(np.asarray(nframes)[0])
    out_len = ((n + 1) // 2 + 1) // 2
    ids = np.rint(np.asarray(wav)[0, ::ALIGN] * 1000.0).astype(np.int32)
    return ids[None, :], np.asarray([out_len], np.int32)


def _frame_id(e):
    # runs of 3 with blanks between: 1,1,1, 2,2,2, 0,0,0, 3,3,3, ...
    r = (e // 3) % 5
    return 0 if r == 4 else r + 1


def _collapse(ids, blank=0):
    out, prev = [], -1
    for t in ids:
        if t != blank and t != prev:
            out.append(t)
        prev = t
    return out


@pytest.mark.parametrize("window,hop,look,n_align,tail", [
    (2.56, 0.32, 0.16, 40, 0),     # steady-state sliding
    (2.56, 0.32, 0.0, 40, 300),    # zero lookahead + a ragged tail
    (1.28, 0.64, 0.48, 17, 639),   # deep lookahead, the tail just short
    (2.56, 2.56, 0.0, 11, 100),    # hop == window (block mode)
])
def test_commit_bookkeeping_fake_step(bf16, window, hop, look, n_align, tail):
    st = StreamingTranscriber(bf16, StreamingConfig(window, hop, look))
    st._step = _fake_step
    total = n_align * ALIGN + tail
    audio = np.asarray([_frame_id(n // ALIGN) / 1000.0 for n in range(total)], np.float32)
    committed_before = 0
    for c in np.split(audio, np.sort(np.random.RandomState(3).randint(1, total, size=6))):
        res = st.feed(c)
        assert res.committed_frames >= committed_before  # monotone commits
        committed_before = res.committed_frames
    res = st.finish()
    n_frames = ((total // 160 + 1) // 2 + 1) // 2
    assert st._tokens == _collapse([_frame_id(e) for e in range(n_frames)])
    assert res.committed_frames == n_frames


def test_trailing_silence_endpoint_signal(bf16):
    """trailing_silence counts committed blank frames since the last voice
    commit: the auto-finalize signal of a serving layer."""
    st = StreamingTranscriber(bf16, StreamingConfig(2.56, 0.32, 0.0))
    st._step = _fake_step
    audio = np.zeros(60 * ALIGN, np.float32)  # voice for 20 frames, then silence
    for n in range(20 * ALIGN):
        audio[n] = ((n // ALIGN) % 3 + 1) / 1000.0
    res = st.feed(audio[:24 * ALIGN])
    assert res.trailing_silence == pytest.approx(4 * ALIGN / SR, abs=1e-6)
    res = st.feed(audio[24 * ALIGN:])
    # 60 frames fed in hops of 8: 56 committed, 36 of them silent
    assert res.trailing_silence == pytest.approx(36 * ALIGN / SR, abs=1e-6)
    assert st.finish().trailing_silence == pytest.approx(40 * ALIGN / SR, abs=1e-6)


def test_api_stream_facade(bf16):
    """api.stream yields a result a chunk plus a final one, whose text is
    the transcriber's driven directly."""
    audio = _audio(1.6, seed=9)
    st = StreamingTranscriber(bf16, SLIDING)
    st.feed(audio)
    want = st.finish().text
    results = list(api.stream(bf16, np.split(audio, 4), SLIDING))
    assert len(results) == 5 and results[-1].is_final
    assert all(not r.is_final for r in results[:-1])
    assert results[-1].text == want


def _drive_pool(pool, audios, hop=int(0.32 * SR), on_step=None):
    """Staggered real-time arrival: hop-sized pieces, a step between ->
    the streams' final texts in open order."""
    sids = [pool.open() for _ in audios]
    offs = [0] * len(audios)
    done = {}
    while len(done) < len(audios):
        for k, sid in enumerate(sids):
            if sid in done:
                continue
            if offs[k] < len(audios[k]):
                pool.feed(sid, audios[k][offs[k]:offs[k] + hop])
                offs[k] += hop
            else:
                done[sid] = pool.finish(sid).text
        results = pool.step()
        if on_step is not None:
            on_step(pool, results)
    return [done[s] for s in sids]


@pytest.mark.parametrize("device_ring", [True, False])
def test_pool_matches_single_stream(f32, device_ring):
    bundle = f32[1]
    audios = [_audio(s, seed=i) for i, s in enumerate([1.6, 0.88, 2.4])]
    singles = []
    for a in audios:
        st = StreamingTranscriber(bundle, SLIDING)
        st.feed(a)
        singles.append(st.finish().text)
    pool = StreamingPool(bundle, slots=4, stream_cfg=SLIDING, device_ring=device_ring)
    assert _drive_pool(pool, audios) == singles


def test_pool_finish_drains_backlog(f32):
    bundle = f32[1]
    audio = _audio(3.2, seed=5)  # 2.5 windows of backlog
    st = StreamingTranscriber(bundle, SLIDING)
    st.feed(audio)
    want = st.finish().text
    pool = StreamingPool(bundle, slots=2, stream_cfg=SLIDING)
    sid = pool.open()
    pool.feed(sid, audio)  # buffered only: no step() at all
    assert pool.finish(sid).text == want


def test_pool_ring_row_reuse_no_leak(f32):
    """A freed ring row is zeroed for the next stream: stream B on a reused
    row transcribes as a fresh pool's stream B does."""
    bundle = f32[1]
    a, b = _audio(1.6, seed=11), _audio(0.8, seed=12)
    pool = StreamingPool(bundle, slots=1, stream_cfg=SLIDING, device_ring=True)
    sa = pool.open()
    pool.feed(sa, a)
    while pool.step():
        pass
    pool.finish(sa)
    assert pool._ring.abs().sum() > 0
    sb = pool.open()  # reuses row 0, whose ring holds stream A's audio
    assert pool._ring.abs().sum() == 0
    pool.feed(sb, b)
    while pool.step():
        pass
    got = pool.finish(sb).text
    fresh = StreamingPool(bundle, slots=1, stream_cfg=SLIDING, device_ring=True)
    sid = fresh.open()
    fresh.feed(sid, b)
    while fresh.step():
        pass
    assert fresh.finish(sid).text == got


def test_pool_slot_limit(bf16):
    pool = StreamingPool(bf16, slots=1, stream_cfg=SLIDING)
    a = pool.open()
    with pytest.raises(RuntimeError, match="full"):
        pool.open()
    pool.finish(a)
    pool.open()  # a freed slot is reusable
    with pytest.raises(ValueError, match="slots"):
        StreamingPool(bf16, slots=0)


def test_validation_errors(bf16):
    with pytest.raises(ValueError, match="multiples"):
        StreamingTranscriber(bf16, StreamingConfig(hop_seconds=0.05))
    with pytest.raises(ValueError, match="cover"):
        StreamingTranscriber(bf16, StreamingConfig(0.64, 0.32, 0.64))
    with pytest.raises(ValueError, match="max_frames"):
        StreamingTranscriber(bf16, StreamingConfig(window_seconds=40.96))
    st = StreamingTranscriber(bf16, StreamingConfig(1.28, 0.32, 0.2))
    st.feed(_audio(0.2))
    st.finish()
    with pytest.raises(RuntimeError, match="finished"):
        st.feed(_audio(0.1))
    with pytest.raises(RuntimeError, match="finished"):
        st.finish()
    wcfg = tcfg.ExperimentConfig(model_family="whisper")
    with pytest.raises(ValueError, match="not 'whisper'; whisper serving is serve/engine.py"):
        StreamingTranscriber(ModelBundle(wcfg, bf16.model, bf16.tokenizer))


# --- port against JAX ----------------------------------------------------------


def _state(st, res):
    return (st._tokens, st._spans, res.text, res.new_text, res.preview, res.committed_frames,
            res.trailing_silence, res.is_final)


@pytest.mark.parametrize("sc", [SLIDING, StreamingConfig(1.92, 0.32, 0.0),
                                StreamingConfig(1.28, 0.64, 0.48)])
def test_transcriber_equals_jax_after_every_feed(f32, sc):
    jb, tb = f32
    audio = _audio(3.3, seed=4)
    js = jstreaming.StreamingTranscriber(jb, jstreaming.StreamingConfig(
        sc.window_seconds, sc.hop_seconds, sc.lookahead_seconds))
    ts = StreamingTranscriber(tb, sc)
    cuts = np.sort(np.random.RandomState(5).randint(1, len(audio), size=7))
    with jax.default_matmul_precision("highest"):
        for c in np.split(audio, cuts):
            assert _state(ts, ts.feed(c)) == _state(js, js.feed(c))
        assert _state(ts, ts.finish()) == _state(js, js.finish())
    assert ts.timed_tokens == js.timed_tokens
    assert ts.timed_words == js.timed_words
    assert ts._tokens  # the comparison is not of empty transcripts


@pytest.mark.parametrize("device_ring", [True, False])
def test_pool_equals_jax_pool_after_every_step(f32, device_ring):
    jb, tb = f32
    audios = [_audio(s, seed=20 + i) for i, s in enumerate([2.2, 0.7, 1.5])]
    jsc = jstreaming.StreamingConfig(1.28, 0.32, 0.16)
    jpool = jstreaming.StreamingPool(jb, slots=4, stream_cfg=jsc, device_ring=device_ring)
    tpool = StreamingPool(tb, slots=4, stream_cfg=SLIDING, device_ring=device_ring)
    states = []

    def on_step(pool, results):
        states.append({sid: (r.text, r.new_text, r.preview, r.committed_frames,
                             r.trailing_silence, r.is_final) for sid, r in results.items()})

    with jax.default_matmul_precision("highest"):
        want = _drive_pool(jpool, audios, on_step=on_step)
        jax_states, states[:] = list(states), []
        got = _drive_pool(tpool, audios, on_step=on_step)
    assert got == want and any(want)
    assert states == jax_states and len(states) > 5


def test_window_log_probs_match_jax(f32):
    """The windows a stream builds, through both packages' featurize and
    encoder: log-probs within F32_BAR on the valid frames."""
    jb, tb = f32
    st = StreamingTranscriber(tb, SLIDING)
    st._append(_audio(2.9, seed=6))
    wins, nfr = [], []
    for end in range(st._hop, st._total + 1, st._hop):
        wav, n, _ = st._build_window(end)
        wins.append(wav)
        nfr.append(n)
    wav, nfr = np.stack(wins), np.asarray(nfr, np.int32)
    model = JModel(jb.config.ctc_model)
    with jax.default_matmul_precision("highest"):
        feats = jfeatures.featurize_batch(jnp.asarray(wav), jb.config.frontend)
        jlp, jlens = model.apply({"params": jb.params}, feats, jnp.asarray(nfr))
    with torch.no_grad():
        tlp, tlens = tb.model(features.featurize_batch(torch.from_numpy(wav), tb.config.frontend),
                              torch.from_numpy(nfr))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    valid = np.arange(tlp.shape[1])[None, :] < tlens.numpy()[:, None]
    diff = np.abs(tlp.numpy() - np.asarray(jlp))[valid]
    assert diff.max() <= F32_BAR, diff.max()


# --- the device ring ---------------------------------------------------------


def test_ring_rows_are_the_host_windows_and_keep_their_addresses(f32):
    """After every ring step each advanced row holds exactly the window
    _build_window assembles for that stream; ring, hop and control buffers
    are written in place (the graph a card replays reads those addresses)."""
    bundle = f32[1]
    pool = StreamingPool(bundle, slots=3, stream_cfg=SLIDING)
    ptrs = [t.data_ptr() for t in (pool._ring, pool._chunk, pool._ctrl)]
    checked = []

    def on_step(pool, results):
        for sid in results:
            st = pool._active[sid]
            wav, _, _ = st._build_window(st._end)
            np.testing.assert_array_equal(pool._ring[pool._rows[sid]].numpy(), wav)
            checked.append(sid)

    audios = [_audio(s, seed=30 + i) for i, s in enumerate([2.6, 1.0, 1.9, 0.5])]
    _drive_pool(pool, audios[:3], on_step=on_step)
    _drive_pool(pool, audios[3:], on_step=on_step)  # a reused row
    assert len(checked) > 10 and 3 in checked
    assert [t.data_ptr() for t in (pool._ring, pool._chunk, pool._ctrl)] == ptrs
    assert pool._graph is None and pool.replays == 0  # the CPU runs the step eagerly


# --- the joint family's CTC branch ----------------------------------------------


@pytest.fixture(scope="module")
def joint():
    """(JAX bundle, port bundle) of a WF-adapted joint model on one seed's
    JAX params (adapters moved off identity), f32, 2.56 s chunks."""
    out = []
    for m in (jcfg, tcfg):
        cfg = m.ExperimentConfig(model_family="joint", joint=m.JointModelConfig(
            vocab_size=8, d_model=32, num_layers=2, decoder_layers=1, num_heads=2, mlp_dim=64,
            conv_channels=16, use_flash_attention=False, dropout=0.0, dtype="float32",
            adapter=m.AdapterConfig(kind="wf", wf_rank=2)))
        cfg.frontend.chunk_seconds = 2.56
        out.append(cfg)
    noise = np.random.RandomState(3)
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 * noise.randn(*x.shape).astype(np.float32),
        JBundle._init_params(out[0]))
    jb = JBundle(config=out[0], params=params, tokenizer=JChar(VOCAB))
    tb = api.load(config=out[1], device="cpu")
    tb.model.load_state_dict(convert.joint_params_to_state_dict(params))
    tb.tokenizer = CharTokenizer(VOCAB)
    return jb, tb


@pytest.mark.parametrize("sc", [SLIDING, StreamingConfig(1.92, 0.32, 0.0)])
def test_joint_transcriber_equals_jax_after_every_feed(joint, sc):
    jb, tb = joint
    audio = _audio(3.3, seed=14)
    js = jstreaming.StreamingTranscriber(jb, jstreaming.StreamingConfig(
        sc.window_seconds, sc.hop_seconds, sc.lookahead_seconds))
    ts = StreamingTranscriber(tb, sc)
    cuts = np.sort(np.random.RandomState(15).randint(1, len(audio), size=7))
    with jax.default_matmul_precision("highest"):
        for c in np.split(audio, cuts):
            assert _state(ts, ts.feed(c)) == _state(js, js.feed(c))
        assert _state(ts, ts.finish()) == _state(js, js.finish())
    assert ts.timed_tokens == js.timed_tokens and ts._tokens


@pytest.mark.parametrize("device_ring", [True, False])
def test_joint_pool_equals_jax_pool_after_every_step(joint, device_ring):
    jb, tb = joint
    audios = [_audio(s, seed=30 + i) for i, s in enumerate([2.2, 0.7, 1.5])]
    jpool = jstreaming.StreamingPool(jb, slots=4, stream_cfg=jstreaming.StreamingConfig(
        1.28, 0.32, 0.16), device_ring=device_ring)
    tpool = StreamingPool(tb, slots=4, stream_cfg=SLIDING, device_ring=device_ring)
    states = []

    def on_step(pool, results):
        states.append({sid: (r.text, r.preview, r.committed_frames)
                       for sid, r in results.items()})

    with jax.default_matmul_precision("highest"):
        want = _drive_pool(jpool, audios, on_step=on_step)
        jax_states, states[:] = list(states), []
        got = _drive_pool(tpool, audios, on_step=on_step)
    assert got == want and any(want)
    assert states == jax_states


def test_joint_finish_matches_offline_ctc_greedy(joint):
    """With the utterance inside one window, finish() is the offline
    ctc_greedy text of the port's bundle and of the JAX bundle."""
    import dataclasses

    jb, tb = joint
    audio = _audio(1.28, seed=16)
    st = StreamingTranscriber(tb, StreamingConfig(2.56, 2.56, 0.0))
    st.feed(audio)
    got = st.finish().text
    dc = dataclasses.replace(tb.config.decode, strategy="ctc_greedy")
    with jax.default_matmul_precision("highest"):
        want = jb.transcribe(audio, decode_cfg=dataclasses.replace(jb.config.decode,
                                                                   strategy="ctc_greedy"))[0]
    assert got == tb.transcribe(audio, decode_cfg=dc)[0] == want
    assert [r.text for r in api.stream(tb, np.split(audio, 4),
                                       StreamingConfig(2.56, 2.56, 0.0))][-1] == got
