"""The port's joint CTC/attention family against the JAX package: the
weight bridge, the encoder, CTC log-probs, teacher-forced logits and every
cached decode step (both cache layouts), joint greedy, the beam (all K
hypotheses and their scores) with CTC rescoring at three weights, the CTC
NLL of the rescoring, the beam's cache build and top-K tie order, a bf16
model under the margin rule, and the bundle (five strategies, timestamps,
save and load). Tiny shapes (tests/test_joint.py's ``tiny_cfg``: f32,
flash attention off), with and without a WF adapter; the same seeded numpy
inputs and the same weights, carried over by the bridge, on both sides;
the JAX side at HIGHEST matmul precision."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.data.tokenizer import CharTokenizer as JTok  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode import joint_generate as jjg  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode import whisper_generate as jwg  # noqa: E402
from jiao_liao_speech_recognition_tpu.models import layers as jlayers  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.joint import JointCTCAttentionModel as JJoint  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops.ctc_loss import ctc_loss as jctc_loss  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import api  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer as TTok  # noqa: E402
from jiao_liao_speech_recognition_torch.decode import joint_generate as tjg  # noqa: E402
from jiao_liao_speech_recognition_torch.decode import whisper_generate as twg  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert, layers  # noqa: E402
from jiao_liao_speech_recognition_torch.models import whisper as twhisper  # noqa: E402
from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle  # noqa: E402
from jiao_liao_speech_recognition_torch.models.joint import JointCTCAttentionModel  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

TINY = dict(vocab_size=32, d_model=32, num_layers=2, decoder_layers=2, num_heads=2,
            mlp_dim=64, conv_channels=16, dropout=0.0, use_flash_attention=False,
            max_target_positions=32)
# f32: the same arithmetic in both packages, sums reordered
F32_BAR = 1e-5
SCORE_BAR = 1e-4  # summed beam log-probs over up to 11 steps, and the CTC NLL
MAX_LEN = 12
ARGMAX_MARGIN = 0.05  # chip_smoke.py's margin rule, for the bf16 model
MIN_COVERAGE = 0.5


def _cfgs(kind="none", dtype="float32", **kw):
    out = []
    for m in (jcfg, tcfg):
        ad = m.AdapterConfig(kind=kind, wf_rank=2, bottleneck_dim=8)
        out.append(m.JointModelConfig(adapter=ad, dtype=dtype, **dict(TINY, **kw)))
    return out


def _inputs(B=3, T=64, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, 80, T).astype(np.float32)
    flens = np.array([T, T // 2, T - 9, T][:B], np.int32)
    return feats, flens


def _pair(kind="none", dtype="float32", seed=0, **kw):
    """(JAX model, JAX params, port model) on one seed's JAX init; adapter
    parameters moved off their identity init."""
    jc, tc = _cfgs(kind, dtype, **kw)
    jm = JJoint(jc)
    feats, flens = _inputs(2)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(feats), jnp.asarray(flens),
                     jnp.zeros((2, 6), jnp.int32))["params"]
    if kind != "none":
        noise = np.random.RandomState(seed + 1)
        params = jax.tree_util.tree_map(
            lambda x: x + 0.05 * noise.randn(*x.shape).astype(np.float32), params)
    tm = JointCTCAttentionModel(tc)
    tm.load_state_dict(convert.joint_params_to_state_dict(params))
    tm.eval()
    if dtype == "bfloat16":
        layers.cast_for_serving(tm, torch.bfloat16)
    return jm, params, tm


@pytest.fixture(scope="module", params=["none", "wf"])
def pair(request):
    return _pair(request.param)


def _t(a):
    return torch.from_numpy(np.array(a))


def _encode(jm, params, tm, feats, flens):
    with jax.default_matmul_precision("highest"):
        enc, el = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(flens),
                           method=jm.encode)
    with torch.inference_mode():
        tenc, tel = tm.encode(_t(feats), _t(flens))
    return enc, el, tenc, tel


def test_weight_bridge_round_trips_every_joint_param(pair):
    _, params, tm = pair
    assert set(convert.joint_params_to_state_dict(params)) == set(tm.state_dict())
    want = convert.flatten_params(params)
    got = convert.flatten_params(convert.joint_state_dict_to_params(tm.state_dict()))
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], np.asarray(want[k])) for k in want)


def test_encoder_ctc_and_teacher_logits_match_jax(pair):
    jm, params, tm = pair
    feats, flens = _inputs()
    enc, el, tenc, tel = _encode(jm, params, tm, feats, flens)
    np.testing.assert_array_equal(tel.numpy(), np.asarray(el))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(enc), atol=F32_BAR, rtol=0)
    toks = np.random.RandomState(3).randint(1, 32, (3, 9)).astype(np.int32)
    toks[:, 0] = 0
    with jax.default_matmul_precision("highest"):
        lp = jm.apply({"params": params}, enc, method=jm.ctc_log_probs)
        ids = jm.apply({"params": params}, enc, method=jm.ctc_argmax_ids)
        tf = jm.apply({"params": params}, jnp.asarray(toks), enc, el, method=jm.decode_teacher)
        full = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(flens),
                        jnp.asarray(toks))
    with torch.inference_mode():
        tenc_j = _t(np.asarray(enc))  # both decoders read the same encoder output
        np.testing.assert_allclose(tm.ctc_log_probs(tenc_j).numpy(), np.asarray(lp),
                                   atol=F32_BAR, rtol=0)
        np.testing.assert_array_equal(tm.ctc_argmax_ids(tenc_j).numpy(), np.asarray(ids))
        got = tm.decode_teacher(_t(toks), tenc_j, _t(np.asarray(el)))
        np.testing.assert_allclose(got.numpy(), np.asarray(tf), atol=F32_BAR, rtol=0)
        tl, tlen, tdec = tm(_t(feats), _t(flens), _t(toks))
    for g, w in zip((tl, tdec), (full[0], full[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_BAR, rtol=0)
    ids, lens = tm.frame_ids(_t(feats), _t(flens))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(full[1]))


@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_every_decode_step_matches_jax(pair, monkeypatch, layout):
    jm, params, tm = pair
    monkeypatch.setattr(jlayers, "HEAD_MAJOR_MIN_BATCH", 1 if layout == "head_major" else 1 << 30)
    feats, flens = _inputs()
    enc, el, _, _ = _encode(jm, params, tm, feats, flens)
    toks = np.random.RandomState(4).randint(1, 32, (3, 10)).astype(np.int32)
    toks[:, 0] = 0
    tenc, tel = _t(np.asarray(enc)), _t(np.asarray(el))
    with jax.default_matmul_precision("highest"):
        caches = jm.apply({"params": params}, 3, enc, 10, method=jm.init_cache)
        tc = tm.init_cache(3, tenc, 10, layout)
        assert (tc["block_0"]["self"]["k"].dim() == 4) == (layout == "head_major")
        for pos in range(10):
            want, caches = jm.apply({"params": params}, jnp.asarray(toks[:, pos:pos + 1]),
                                    jnp.int32(pos), enc, caches, el, method=jm.decode_step)
            with torch.inference_mode():
                got, tc = tm.decode_step(_t(toks[:, pos:pos + 1]), pos, tenc, tc, tel)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_BAR, rtol=0,
                                       err_msg=f"step {pos}")


def test_joint_greedy_matches_jax(pair):
    jm, params, tm = pair
    feats, flens = _inputs()
    with jax.default_matmul_precision("highest"):
        want, want_len = jjg.joint_greedy(jm, params, jnp.asarray(feats), jnp.asarray(flens),
                                          max_len=MAX_LEN)
    got, got_len = tjg.joint_greedy(tm, _t(feats), _t(flens), max_len=MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got.shape == (3, MAX_LEN - 1)


@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_beam_hypotheses_and_scores_match_jax(pair, monkeypatch, layout):
    """All K beams, their lengths and summed log-probs from the shared beam
    loop, in both cache layouts (B * K = 12)."""
    jm, params, tm = pair
    monkeypatch.setattr(jlayers, "HEAD_MAJOR_MIN_BATCH", 1 if layout == "head_major" else 1 << 30)
    monkeypatch.setattr(twhisper, "HEAD_MAJOR_MIN_BATCH", 1 if layout == "head_major" else 1 << 30)
    feats, flens = _inputs()
    enc, el, _, _ = _encode(jm, params, tm, feats, flens)
    with jax.default_matmul_precision("highest"):
        gen, lens, scores = jwg.beam_from_enc(jm, params, enc, el, beam_size=4, max_len=MAX_LEN,
                                              prompt=(0,), eot_id=0)
    tgen, tlens, tscores = twg.beam_from_enc(tm, _t(np.asarray(enc)), _t(np.asarray(el)), 4,
                                             MAX_LEN, (0,), 0)
    np.testing.assert_array_equal(tgen.numpy(), np.asarray(gen))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(lens))
    np.testing.assert_allclose(tscores.numpy(), np.asarray(scores), atol=SCORE_BAR, rtol=0)


@pytest.mark.parametrize("ctc_weight", [0.0, 0.3, 1.0])
def test_joint_beam_with_ctc_rescoring_matches_jax(pair, ctc_weight):
    jm, params, tm = pair
    feats, flens = _inputs()
    with jax.default_matmul_precision("highest"):
        want, want_len = jjg.joint_beam(jm, params, jnp.asarray(feats), jnp.asarray(flens),
                                        beam_size=3, max_len=MAX_LEN, ctc_weight=ctc_weight)
    got, got_len = tjg.joint_beam(tm, _t(feats), _t(flens), 3, MAX_LEN, ctc_weight=ctc_weight)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    if ctc_weight > 0.0:  # the NLL against the JAX loss on the same hypotheses
        with torch.inference_mode():
            tenc, tel = tm.encode(_t(feats), _t(flens))
            gen, lens, _ = twg.beam_from_enc(tm, tenc, tel, 3, MAX_LEN, (0,), 0)
            nll = tjg.ctc_rescore(tm, tenc, tel, gen, lens)
        with jax.default_matmul_precision("highest"):
            enc, el = jm.apply({"params": params}, jnp.asarray(feats), jnp.asarray(flens),
                               method=jm.encode)
            lp = jm.apply({"params": params}, enc, method=jm.ctc_log_probs)
        B, K, L = gen.shape
        jnll = jctc_loss(jnp.repeat(lp, K, axis=0), jnp.repeat(el, K, axis=0),
                                  jnp.asarray(gen.reshape(B * K, L).numpy()),
                                  jnp.asarray(lens.reshape(B * K).numpy()))
        np.testing.assert_allclose(nll.reshape(-1).numpy(), np.asarray(jnll), atol=SCORE_BAR,
                                   rtol=0)


def test_config_ctc_weight_is_the_default(pair):
    jm, params, tm = pair
    feats, flens = _inputs()
    a = tjg.joint_beam(tm, _t(feats), _t(flens), 3, MAX_LEN)
    b = tjg.joint_beam(tm, _t(feats), _t(flens), 3, MAX_LEN, ctc_weight=tm.cfg.ctc_weight)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_beam_of_one_is_greedy_bitwise(pair):
    _, _, tm = pair
    feats, flens = _inputs()
    g = tjg.joint_greedy(tm, _t(feats), _t(flens), max_len=MAX_LEN)
    b = tjg.joint_beam(tm, _t(feats), _t(flens), 1, MAX_LEN, ctc_weight=0.0)
    assert all(torch.equal(x, y) for x, y in zip(g, b))


@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_beam_caches_are_the_repeated_encoder_caches_bitwise(pair, layout):
    """init_cache(B, enc, beams=K): the cross K/V projected once and
    repeated, bit for bit init_cache over enc repeated K times."""
    _, _, tm = pair
    enc = torch.from_numpy(np.random.RandomState(7).randn(3, 16, 32).astype(np.float32))
    with torch.inference_mode():
        got = tm.init_cache(3, enc, MAX_LEN, layout, beams=4)
        want = tm.init_cache(12, enc.repeat_interleave(4, 0), MAX_LEN, layout)
    for blk in want:
        for kind in ("self", "cross"):
            for n, t in want[blk][kind].items():
                assert torch.equal(got[blk][kind][n], t), (blk, kind, n)


def test_top_k_order_of_forced_ties_is_lax_top_k():
    """Dead beams sit at -1e30, and -1e30 + logp rounds to -1e30 in f32:
    the top K among ties must be the lowest flat indices, as lax.top_k."""
    rng = np.random.RandomState(0)
    x = np.round(rng.randn(4, 64), 1).astype(np.float32)  # many exact ties
    x[1, :] = np.float32(-1e30) + rng.randn(64).astype(np.float32)  # all -1e30
    x[2, ::3] = 5.0
    vals, idx = twg.top_k_stable(torch.from_numpy(x), 8)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx[1].tolist() == list(range(8)) and idx[2].tolist() == list(range(0, 24, 3))


def test_bf16_model_tokens_hold_under_the_margin_rule():
    """A bf16 model: the port's greedy and beam tokens, teacher-forced
    through the JAX model, are its argmax wherever the top-2 margin clears
    ARGMAX_MARGIN; CTC ids likewise against the JAX log-probs."""
    jm, params, tm = _pair("wf", "bfloat16", seed=2)
    feats, flens = _inputs(seed=5)
    enc, el, tenc, tel = _encode(jm, params, tm, feats, flens)
    gen, lens = tjg.joint_greedy(tm, _t(feats), _t(flens), max_len=MAX_LEN)
    bgen, blens = tjg.joint_beam(tm, _t(feats), _t(flens), 3, MAX_LEN, ctc_weight=0.0)
    ids = tm.ctc_argmax_ids(tenc)
    with jax.default_matmul_precision("highest"):
        lp = np.asarray(jm.apply({"params": params}, enc, method=jm.ctc_log_probs), np.float32)
    top2 = np.sort(lp, -1)[..., -2:]
    frames = np.arange(lp.shape[1])[None] < np.asarray(el)[:, None]
    clear = frames & (top2[..., 1] - top2[..., 0] > ARGMAX_MARGIN)
    assert clear.sum() >= MIN_COVERAGE * frames.sum()
    assert (ids.numpy() == lp.argmax(-1))[clear].all()
    for g, n in ((gen, lens), (bgen, blens)):
        toks = np.concatenate([np.zeros((3, 1), np.int64), g.numpy()], 1)
        with jax.default_matmul_precision("highest"):
            logits = np.asarray(jm.apply({"params": params}, jnp.asarray(toks[:, :-1]), enc, el,
                                         method=jm.decode_teacher), np.float32)
        top2 = np.sort(logits, -1)[..., -2:]
        scored = np.arange(MAX_LEN - 1)[None] < np.minimum(n.numpy() + 1, MAX_LEN - 1)[:, None]
        clear = scored & (top2[..., 1] - top2[..., 0] > ARGMAX_MARGIN)
        assert clear.sum() >= MIN_COVERAGE * scored.sum()
        if g is gen:  # greedy: every clear position is the JAX argmax
            assert (logits.argmax(-1) == toks[:, 1:])[clear].all()


def test_att_adapter_decode_is_refused_by_name(monkeypatch):
    """The Att adapter's cached decode is ported (no longer refused): in
    both cache layouts the joint decoder's init_cache carries each block's
    slot caches, shaped as JAX's init_cache makes them, and every cached
    step's logits are within 1e-5 of the teacher-forced pass's."""
    jm, params, tm = _pair("att")
    rng = np.random.RandomState(8)
    feats, flens = _inputs(2)
    toks = torch.from_numpy(rng.randint(0, 32, (2, 6)))
    for layout in ("packed", "head_major"):
        with torch.no_grad():
            enc, el = tm.encode(_t(feats), _t(flens))
            full = tm.decode_teacher(toks, enc, el)
            caches = tm.init_cache(2, enc, 10, layout)
            for pos in range(6):
                logits, caches = tm.decode_step(toks[:, pos:pos + 1], pos, enc, caches, el)
                np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), atol=1e-5)
        monkeypatch.setattr(jlayers, "HEAD_MAJOR_MIN_BATCH", 1 if layout == "head_major"
                            else 1 << 30)
        jcache = jm.apply({"params": params}, 2, jnp.asarray(enc.numpy()), 10,
                          method=jm.init_cache)
        for name, entry in caches.items():
            for s, slot in entry["slots"].items():
                for n, t in slot.items():
                    want = jcache[name.replace("block_", "dec_block_")]["slots"][s][n].shape
                    assert tuple(t.shape) == want, (name, s, n)


# --- the bundle -----------------------------------------------------------------

VOCAB = [chr(0x4E00 + i) for i in range(30)]


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """(JAX bundle, port bundle loaded from a port checkpoint) on one seed's
    JAX params of a WF-adapted joint config with 2 s chunks."""
    jm, params, tm = _pair("wf", seed=4)
    cfgs = []
    for m, mc in zip((jcfg, tcfg), _cfgs("wf")):
        cfg = m.ExperimentConfig(model_family="joint", joint=mc)
        cfg.frontend.chunk_seconds = 2.0
        cfg.decode.max_decode_len = MAX_LEN
        cfg.decode.beam_size = 3
        cfgs.append(cfg)
    jb = JBundle(config=cfgs[0], params=params, tokenizer=JTok(VOCAB))
    ckpt = tmp_path_factory.mktemp("joint") / "ckpt"
    ModelBundle(cfgs[1], tm, TTok(VOCAB)).save(str(ckpt))
    return jb, api.load(checkpoint=str(ckpt), device="cpu")


def _audio():
    rng = np.random.RandomState(6)
    return [(0.1 * rng.randn(int(16000 * s))).astype(np.float32) for s in (1.0, 3.0, 0.4)]


@pytest.mark.parametrize("strategy", ["ctc_greedy", "greedy", "beam", "beam_device",
                                      "spec_greedy"])
def test_bundle_transcribe_matches_jax(bundles, strategy):
    jb, tb = bundles
    assert isinstance(tb.model, JointCTCAttentionModel) and tb.is_joint
    dc = dataclasses.replace(jb.config.decode, strategy=strategy)
    with jax.default_matmul_precision("highest"):
        want = jb.transcribe(_audio(), decode_cfg=dc)
    got = tb.transcribe(_audio(), decode_cfg=dataclasses.replace(tb.config.decode,
                                                                 strategy=strategy))
    assert got == want
    if strategy == "greedy":
        assert any(want) and got == api.transcribe(tb, _audio())  # the config's default


def test_bundle_transcribe_timed_matches_jax(bundles):
    jb, tb = bundles
    with jax.default_matmul_precision("highest"):
        want = jb.transcribe_timed(_audio())
    assert api.transcribe(tb, _audio(), timestamps=True) == want
    assert any(want)


def test_bundle_save_load_and_refusals(bundles, tmp_path):
    _, tb = bundles
    tb.save(str(tmp_path / "again"))
    back = api.load(checkpoint=str(tmp_path / "again"), device="cpu")
    assert back.config.model_family == "joint" and back.tokenizer.vocab == tb.tokenizer.vocab
    sd = back.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in tb.model.state_dict().items())
    with pytest.raises(NotImplementedError, match="whisper family"):
        tb.quantize()
    with pytest.raises(ValueError, match="unknown joint decode strategy"):
        tb.transcribe(_audio()[0], decode_cfg=tcfg.DecodeConfig(strategy="banana"))
    cfg = tcfg.ExperimentConfig(model_family="joint", joint=tcfg.JointModelConfig(num_mels=128))
    with pytest.raises(ValueError, match="num_mels"):
        api.load(config=cfg, device="cpu")


def test_full_width_joint_config_loads_on_the_cpu():
    """configs/joint_ctc_attention.yaml at its published widths: 12 + 6
    blocks of d 512, 4 heads of 128, mlp 2048, V 4336, WF rank 8."""
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "configs" / "joint_ctc_attention.yaml"
    cfg = tcfg.load_yaml(str(path))
    want = jcfg.load_yaml(str(path))
    assert dataclasses.asdict(cfg.joint) == dataclasses.asdict(want.joint)
    tb = api.load(config=cfg, device="cpu")
    m = tb.model
    assert len(m.enc_blocks) == 12 and len(m.dec_blocks) == 6
    assert m.embed_tokens.embedding.shape == (4336, 512)
    assert m.enc_blocks[0].mlp.fc1.adapter_wf.a.shape == (512, 8)
    assert m.dec_blocks[0].cross_attn.q_proj.adapter_wf.a.shape == (512, 8)
    assert tb.config.decode.strategy == "beam" and tb.config.decode.beam_size == 8
