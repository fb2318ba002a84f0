"""The port's Whisper slice against the JAX package: K9 and K5 (plain
versions against the JAX kernel in interpret mode / its XLA reference), the
cache writes, the weight bridge, teacher-forced logits, greedy tokens in
both cache layouts, the BPE twin, and the bundle. Small shapes (d=64, 2+2
layers, 4 heads, V=50), the same seeded numpy inputs on both sides."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.data import bpe as jbpe  # noqa: E402
from jiao_liao_speech_recognition_tpu.decode import whisper_generate as jwg  # noqa: E402
from jiao_liao_speech_recognition_tpu.models import layers as jlayers  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.whisper import WhisperModel as JWhisper  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops import decode_attention as jda  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops import fused_mlp as jfm  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch import api  # noqa: E402
from jiao_liao_speech_recognition_torch.data import bpe as tbpe  # noqa: E402
from jiao_liao_speech_recognition_torch.decode import whisper_generate as twg  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert, layers  # noqa: E402
from jiao_liao_speech_recognition_torch.models.whisper import WhisperModel  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import decode_attention as tda  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import fused_attention as tfa  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import fused_mlp as tfm  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

SMALL = dict(vocab_size=50, d_model=64, encoder_layers=2, decoder_layers=2, num_heads=4,
             mlp_dim=128, max_target_positions=24, use_flash_attention=False)
EOT = 2
PROMPT = (1, 3)
# f32: the same arithmetic in both packages, sums reordered (the JAX import
# test's logit bar)
F32_LOGIT_BAR = 2e-4
ULP_BAR = 2.0  # bf16 ulps of the output magnitude


def _ulps(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / ulp)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def jax_f32():
    cfg = jcfg.WhisperConfig(dtype="float32", **SMALL)
    model = JWhisper(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 80, 60)),
                        jnp.zeros((1, 4), jnp.int32))["params"]
    return model, params


def _port(params, dtype="float32"):
    model = WhisperModel(tcfg.WhisperConfig(dtype=dtype, **SMALL))
    model.load_state_dict(convert.whisper_params_to_state_dict(params))
    model.eval()
    if dtype == "bfloat16":
        layers.cast_for_serving(model, torch.bfloat16)
    return model


def _mel(B, seed=1, T=60):
    return (np.random.RandomState(seed).randn(B, 80, T) * 0.3).astype(np.float32)


# --- K9 ----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["ragged_cross", "self_256", "tq4"])
def test_k9_plain_matches_jax_kernel(case):
    rng = np.random.RandomState(0)
    B, H, dh = 4, 4, 64
    Tq, Tk, lens = {"ragged_cross": (1, 384, [300, 1, 0, 384]),
                    "self_256": (1, 256, [1, 17, 200, 256]),
                    "tq4": (4, 128, [128, 5, 0, 64])}[case]
    q = _bf16(rng.randn(B, H, Tq, dh))
    k, v = (_bf16(rng.randn(B, H, Tk, dh)) for _ in range(2))
    want = np.asarray(jda.grouped_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
        jnp.asarray(lens, jnp.int32)))
    tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = tda.grouped_decode_attention(tq, tk, tv, torch.tensor(lens, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == (B, H, Tq, dh)
    assert np.isfinite(got.numpy()).all()  # the zero-length row is uniform, not NaN
    assert _ulps(got.numpy(), want) <= ULP_BAR


def test_k9_rejects_an_unpadded_horizon_like_jax():
    q = np.zeros((1, 2, 1, 64), np.float32)
    k = np.zeros((1, 2, 200, 64), np.float32)
    lens = np.array([10], np.int32)
    with pytest.raises(ValueError, match="128-padded"):
        jda.grouped_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                                     jnp.asarray(lens))
    with pytest.raises(ValueError, match="128-padded"):
        tda.grouped_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(k), torch.from_numpy(lens))
    k8, sc = torch.zeros(1, 2, 200, 64, dtype=torch.int8), torch.ones(1, 2, 200)
    with pytest.raises(ValueError, match="128-padded"):  # int8 caches alike
        jda.grouped_decode_attention(jnp.asarray(q), jnp.asarray(k8.numpy()),
                                     jnp.asarray(k8.numpy()), jnp.asarray(lens),
                                     k_scale=jnp.asarray(sc.numpy()), v_scale=jnp.asarray(sc.numpy()))
    with pytest.raises(ValueError, match="128-padded"):
        tda.grouped_decode_attention(torch.from_numpy(q), k8, k8, torch.from_numpy(lens),
                                     k_scale=sc, v_scale=sc)


def test_k9_padding_helpers_match_jax():
    assert [tda.round_tk(t) for t in (1, 128, 129, 1500)] == \
        [jda.round_tk(t) for t in (1, 128, 129, 1500)] == [128, 128, 256, 1536]
    a = np.random.RandomState(0).randn(2, 3, 130, 4).astype(np.float32)
    np.testing.assert_array_equal(tda.pad_time_to_tk(torch.from_numpy(a), 2).numpy(),
                                  np.asarray(jda.pad_time_to_tk(jnp.asarray(a), 2)))
    b = a[:, :, :128]
    assert tda.pad_time_to_tk(torch.from_numpy(b), 2).shape[2] == 128


# --- K5 ----------------------------------------------------------------------


def test_k5_plain_matches_jax_reference():
    rng = np.random.RandomState(3)
    B, T, d = 2, 70, 128
    x = _bf16(rng.randn(B, T, d))
    g, bl = 1.0 + 0.1 * rng.randn(d), 0.1 * rng.randn(d)
    ws = [0.05 * rng.randn(d, d) for _ in range(3)]
    bq, bv = 0.1 * rng.randn(d), 0.1 * rng.randn(d)
    args = [a.astype(np.float32) for a in (g, bl, ws[0], bq, ws[1], ws[2], bv)]
    want = jfm._ln_qkv_reference(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, args), 1e-5)
    g_t, bl_t, *w_t = map(torch.from_numpy, args)
    w_qkv, b_qkv = tfm.pack_qkv(*w_t)
    assert tuple(w_qkv.shape) == (d, 3 * d) and not b_qkv[d:2 * d].any()  # k has no bias
    got = tfm.fused_ln_qkv(torch.tensor(x).to(torch.bfloat16), g_t, bl_t, w_qkv, b_qkv, 1e-5)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == (B, T, d)
        assert _ulps(a.float().numpy(), np.asarray(b, np.float32)) <= ULP_BAR, name


def test_out_proj_residual_plain_matches_jax_route():
    """The out-projection + residual after flash: x + (attn . wo + bo) in
    bf16, as the JAX block's long-context route computes it."""
    rng = np.random.RandomState(4)
    B, T, d = 2, 70, 128
    x, attn = _bf16(rng.randn(B, T, d)), _bf16(rng.randn(B, T, d))
    wo, bo = (0.05 * rng.randn(d, d)).astype(np.float32), (0.1 * rng.randn(d)).astype(np.float32)
    bf = jnp.bfloat16
    want = jnp.asarray(x, bf) + (jax.lax.dot_general(
        jnp.asarray(attn, bf), jnp.asarray(wo).astype(bf), (((2,), (0,)), ((), ())))
        + jnp.asarray(bo).astype(bf))
    got = tfa.out_proj_residual(torch.tensor(x).to(torch.bfloat16),
                                torch.tensor(attn).to(torch.bfloat16),
                                torch.from_numpy(wo), torch.from_numpy(bo))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, T, d)
    assert _ulps(got.float().numpy(), np.asarray(want, np.float32)) <= ULP_BAR


# --- cache writes --------------------------------------------------------------


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("per_row", [False, True])
def test_update_cache_rows_matches_jax(axis, per_row):
    rng = np.random.RandomState(0)
    shape = (3, 5, 4) if axis == 1 else (3, 2, 5, 4)
    cache = rng.randn(*shape).astype(np.float32)
    new_shape = list(shape)
    new_shape[axis] = 1
    new = rng.randn(*new_shape).astype(np.float32)
    index = np.array([0, 4, 2], np.int32) if per_row else 3
    want = np.asarray(jlayers.update_cache_rows(jnp.asarray(cache), jnp.asarray(new),
                                                jnp.asarray(index), axis))
    t = torch.from_numpy(cache.copy())
    idx = torch.from_numpy(index) if per_row else index
    got = layers.update_cache_rows(t, torch.from_numpy(new), idx, axis)
    assert got is t  # in place
    np.testing.assert_array_equal(got.numpy(), want)


# --- model -------------------------------------------------------------------


def test_weight_bridge_maps_every_jax_whisper_param(jax_f32):
    _, params = jax_f32
    state = convert.whisper_params_to_state_dict(params)
    model = WhisperModel(tcfg.WhisperConfig(dtype="float32", **SMALL))
    assert set(state) == set(model.state_dict())
    for key, t in model.state_dict().items():
        assert tuple(state[key].shape) == tuple(t.shape), key
    back = convert.flatten_params(convert.whisper_state_dict_to_params(state))
    flat = convert.flatten_params(params)
    assert set(back) == set(flat)
    for path, a in flat.items():
        np.testing.assert_array_equal(back[path], np.asarray(a))


def test_teacher_forced_logits_f32_match_jax(jax_f32):
    jm, params = jax_f32
    mel = _mel(2)
    toks = np.random.RandomState(2).randint(0, 50, (2, 7)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(mel), jnp.asarray(toks)))
    model = _port(params)
    with torch.no_grad():
        got = model(torch.from_numpy(mel), torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape == (2, 7, 50)
    assert np.abs(got - want).max() < F32_LOGIT_BAR


def test_decode_steps_match_teacher_forcing_in_both_layouts(jax_f32):
    """Cached steps (packed and head-major) give the teacher-forced
    logits at every position."""
    _, params = jax_f32
    model = _port(params)
    mel = torch.from_numpy(_mel(2, seed=4))
    toks = torch.from_numpy(np.random.RandomState(5).randint(0, 50, (2, 6)))
    with torch.no_grad():
        enc = model.encode(mel)
        full = model.decode(toks, enc)
        for layout in ("packed", "head_major"):
            caches = model.init_cache(2, enc, 10, layout)
            for pos in range(6):
                logits, caches = model.decode_step(toks[:, pos:pos + 1], pos, enc, caches)
                np.testing.assert_allclose(logits.numpy(), full[:, pos].numpy(), atol=1e-5)


def test_init_cache_layouts_and_padding(jax_f32):
    _, params = jax_f32
    model = _port(params)
    enc = torch.zeros(2, 30, 64)
    c = model.init_cache(2, enc, 12)["block_0"]
    assert tuple(c["self"]["k"].shape) == (2, 12, 64)
    assert tuple(c["cross"]["k"].shape) == (2, 30, 64)
    c = model.init_cache(2, enc, 12, "head_major")["block_1"]
    assert tuple(c["self"]["k"].shape) == (2, 4, 128, 16)
    assert tuple(c["cross"]["v"].shape) == (2, 4, 128, 16)
    big = model.init_cache(16, torch.zeros(16, 30, 64), 12)["block_0"]
    assert big["self"]["k"].dim() == 4  # the CPU default follows the JAX threshold
    with pytest.raises(ValueError, match="layout"):
        model.init_cache(2, enc, 12, "banana")


@pytest.mark.parametrize("layout", ["packed", "head_major"])
@pytest.mark.parametrize("suppress", [False, True])
def test_greedy_tokens_f32_match_jax(jax_f32, monkeypatch, layout, suppress):
    jm, params = jax_f32
    mel = _mel(2, seed=7)
    sup, bsup = ((5, 11, 17), (4, 9)) if suppress else ((), ())
    monkeypatch.setattr(jlayers, "HEAD_MAJOR_MIN_BATCH", 1 if layout == "head_major" else 1 << 30)
    with jax.default_matmul_precision("highest"):
        want, want_len = jwg.greedy_generate(jm, params, jnp.asarray(mel), max_len=14,
                                             prompt=PROMPT, eot_id=EOT, suppress_ids=sup,
                                             begin_suppress_ids=bsup)
    got, got_len = twg.greedy_generate(_port(params), torch.from_numpy(mel), 14, PROMPT, EOT,
                                       suppress_ids=sup, begin_suppress_ids=bsup, layout=layout)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    if suppress:
        assert not np.isin(got.numpy(), sup).any()


def test_greedy_tokens_bf16_match_jax_with_k9(monkeypatch):
    """bf16 caches, head-major: the JAX side runs K9 in interpret mode
    (_on_tpu patched on), the port K9's plain version. Both decode from the
    same encoder output."""
    cfg = jcfg.WhisperConfig(dtype="bfloat16", **SMALL)
    jm = JWhisper(cfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 80, 60)),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    mel = _mel(2, seed=8)
    monkeypatch.setattr(jlayers, "_on_tpu", lambda: True)
    monkeypatch.setattr(jlayers, "HEAD_MAJOR_MIN_BATCH", 1)
    calls = []
    real = jda.grouped_decode_attention
    monkeypatch.setattr(jda, "grouped_decode_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    enc = jm.apply({"params": params}, jnp.asarray(mel), method=jm.encode)
    want, want_len = jwg.greedy_from_enc(jm, params, enc, None, max_len=12, prompt=PROMPT,
                                         eot_id=EOT)
    assert calls, "the JAX side did not take K9"
    model = _port(params, "bfloat16")
    enc_t = torch.from_numpy(np.asarray(enc, np.float32)).to(torch.bfloat16)
    tda.COUNTER.reset()
    got, got_len = twg.greedy_from_enc(model, enc_t, None, 12, PROMPT, EOT, layout="head_major")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert tda.COUNTER.launches == 0  # CPU tensors take the plain version


def test_temperature_sampling_is_consumed(jax_f32):
    _, params = jax_f32
    model = _port(params)
    mel = torch.from_numpy(_mel(2, seed=9))
    g0, _ = twg.greedy_generate(model, mel, 12, PROMPT, EOT)

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        return twg.greedy_generate(model, mel, 12, PROMPT, EOT, temperature=2.0,
                                   generator=gen)[0]

    s1, s2 = sample(3), sample(3)
    assert torch.equal(s1, s2), "sampling is not deterministic per generator"
    assert not torch.equal(s1, g0)


def test_generate_strategies(jax_f32):
    _, params = jax_f32
    cfg = tcfg.ExperimentConfig(model_family="whisper", whisper=tcfg.WhisperConfig(
        dtype="float32", prompt_ids=PROMPT, eot_id=EOT, **SMALL))
    bundle = type("B", (), {"config": cfg, "model": _port(params)})()
    mel = torch.from_numpy(_mel(1))
    ids, lens = twg.generate(bundle, mel, tcfg.DecodeConfig(max_decode_len=10))
    assert ids.shape == (1, 10 - len(PROMPT))
    for strategy in ("beam", "beam_device"):  # the AR beam, capped at max_target_positions
        ids, lens = twg.generate(bundle, mel, tcfg.DecodeConfig(strategy=strategy, beam_size=3))
        assert ids.shape == (1, SMALL["max_target_positions"] - len(PROMPT))
    with pytest.raises(ValueError, match="unknown whisper decode"):
        twg.generate(bundle, mel, tcfg.DecodeConfig(strategy="banana"))
    assert twg.default_prompt(51866) == jwg.default_prompt(51866)
    assert twg.default_prompt() == jwg.default_prompt()
    assert twg.resolve_specials(bundle.config.whisper) == (PROMPT, EOT)


@pytest.mark.parametrize("strategy", ["beam", "beam_device"])
@pytest.mark.parametrize("beam_size", [1, 2])
def test_generate_beam_of_one_is_greedy(jax_f32, strategy, beam_size):
    """A beam of one is greedy in both packages (the JAX generate dispatches
    it so); a wider one is the AR beam in both: the same tokens from the
    same weights and mel."""
    jm, params = jax_f32
    wcfg = dict(prompt_ids=PROMPT, eot_id=EOT, **SMALL)
    dcfg = dict(strategy=strategy, beam_size=beam_size, max_decode_len=12)
    bundle = type("B", (), {"config": tcfg.ExperimentConfig(
        model_family="whisper", whisper=tcfg.WhisperConfig(dtype="float32", **wcfg)),
        "model": _port(params)})()
    mel = _mel(2, seed=14)
    jbundle = type("B", (), {"config": jcfg.ExperimentConfig(
        model_family="whisper", whisper=jcfg.WhisperConfig(dtype="float32", **wcfg)),
        "params": params})()
    with jax.default_matmul_precision("highest"):
        want, want_len = jwg.generate(jbundle, jnp.asarray(mel), jcfg.DecodeConfig(**dcfg))
    got, got_len = twg.generate(bundle, torch.from_numpy(mel), tcfg.DecodeConfig(**dcfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    if beam_size == 1:
        greedy, _ = twg.greedy_generate(bundle.model, torch.from_numpy(mel), 12, PROMPT, EOT)
        assert torch.equal(got, greedy)


@pytest.mark.parametrize("layout", ["packed", "head_major"])
def test_beam_generate_matches_jax_in_both_layouts(jax_f32, monkeypatch, layout):
    """Whisper's beam_generate: every beam of beam_from_enc (tokens,
    lengths, scores) and the chosen one against JAX's, with suppression and
    a length penalty, in both cache layouts (B * K = 6)."""
    jm, params = jax_f32
    monkeypatch.setattr(jlayers, "HEAD_MAJOR_MIN_BATCH", 1 if layout == "head_major" else 1 << 30)
    mel = _mel(2, seed=15)
    sup, bsup = (5, 11), (4,)
    with jax.default_matmul_precision("highest"):
        enc = jm.apply({"params": params}, jnp.asarray(mel), method=jm.encode)
        want = jwg.beam_from_enc(jm, params, enc, None, beam_size=3, max_len=14, prompt=PROMPT,
                                 eot_id=EOT, suppress_ids=sup, begin_suppress_ids=bsup)
        best = jwg.beam_generate(jm, params, jnp.asarray(mel), beam_size=3, max_len=14,
                                 length_penalty=0.6, prompt=PROMPT, eot_id=EOT,
                                 suppress_ids=sup, begin_suppress_ids=bsup)
    model = _port(params)
    got = twg.beam_from_enc(model, torch.from_numpy(np.array(enc)), None, 3, 14, PROMPT, EOT,
                            suppress_ids=sup, begin_suppress_ids=bsup, layout=layout)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4, rtol=0)
    got_best = twg.beam_generate(model, torch.from_numpy(mel), 3, 14, 0.6, PROMPT, EOT,
                                 suppress_ids=sup, begin_suppress_ids=bsup, layout=layout)
    for g, w in zip(got_best, best):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not np.isin(got[0].numpy(), sup).any()


def test_generate_beam_takes_the_lm_from_the_decode_config(jax_f32, tmp_path):
    """decode.lm_path + lm_weight > 0 fuse the LM's bigram matrix into the
    beam, as the JAX bundle's generate does; weight 0 is the plain beam."""
    from jiao_liao_speech_recognition_tpu.decode.lm import NGramCharLM as JLM

    jm, params = jax_f32
    lm = JLM.train([[7, 8, 7, 8, 9], [7, 9, 9]], order=2, vocab_size=SMALL["vocab_size"])
    lm.save(tmp_path / "lm.npz")
    wcfg = dict(prompt_ids=PROMPT, eot_id=EOT, dtype="float32", **SMALL)
    bundle = type("B", (), {"config": tcfg.ExperimentConfig(
        model_family="whisper", whisper=tcfg.WhisperConfig(**wcfg)), "model": _port(params)})()
    mel = _mel(2, seed=16)
    outs = {}
    for w in (0.0, 3.0):
        dcfg = dict(strategy="beam", beam_size=2, max_decode_len=10,
                    lm_path=str(tmp_path / "lm.npz"), lm_weight=w)
        with jax.default_matmul_precision("highest"):
            mat = jwg.load_bigram_matrix(str(tmp_path / "lm.npz"), SMALL["vocab_size"])
            want = jwg.beam_generate(jm, params, jnp.asarray(mel), beam_size=2, max_len=10,
                                     prompt=PROMPT, eot_id=EOT,
                                     lm_bigram=mat if w else None, lm_weight=w)
        got = twg.generate(bundle, torch.from_numpy(mel), tcfg.DecodeConfig(**dcfg))
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        outs[w] = got[0]
    assert not torch.equal(outs[0.0], outs[3.0])


def test_encoder_k5_route_matches_k2_route(jax_f32, monkeypatch):
    """The route the card takes at d=1280 (K5, K6, out-projection +
    residual) and the K2 route compute one function: in bf16 they differ
    by roundings only."""
    _, params = jax_f32
    model = _port(params, "bfloat16")
    mel = torch.from_numpy(_mel(2, seed=10, T=200))
    with torch.no_grad():
        monkeypatch.setattr(layers, "attention_sublayer_fits", lambda d, h: True)
        k2 = model.encode(mel).float()
        monkeypatch.setattr(layers, "attention_sublayer_fits", lambda d, h: False)
        k5 = model.encode(mel).float()
    rel = float((k5 - k2).norm() / k2.norm())
    assert 0 < rel < 0.02, rel


def _bf16_port_of(state):
    model = WhisperModel(tcfg.WhisperConfig(dtype="bfloat16", **SMALL))
    model.load_state_dict(state)
    model.eval()
    layers.cast_for_serving(model, torch.bfloat16)
    return model


@pytest.mark.parametrize("change", ["load_state_dict", "in_place", "data_swap",
                                    "optimizer_step"])
def test_serving_copies_follow_weight_changes(jax_f32, change):
    """A bf16 serving model whose f32 weights change after its serving
    copies were made computes with the new weights, exactly as a model
    built from them (the encoder's K5 route, Dense layers and the tied
    head all keep copies)."""
    jm, params = jax_f32
    model = _port(params, "bfloat16")
    mel = torch.from_numpy(_mel(2, seed=11))
    toks = torch.from_numpy(np.random.RandomState(12).randint(0, 50, (2, 5)))
    with torch.no_grad():
        before = model(mel, toks)
        if change == "load_state_dict":
            other = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, 80, 60)),
                            jnp.zeros((1, 4), jnp.int32))["params"]
            model.load_state_dict(convert.whisper_params_to_state_dict(other))
        elif change == "in_place":
            for p in model.parameters():
                p.mul_(1.25)
        elif change == "data_swap":
            for p in model.parameters():
                p.data = p.data * 1.25
    if change == "optimizer_step":
        model.train()
        opt = torch.optim.SGD(model.parameters(), lr=0.5)
        model(mel, toks).float().logsumexp(-1).mean().backward()
        opt.step()
        model.eval()
    with torch.no_grad():
        after = model(mel, toks)
        want = _bf16_port_of({k: v.clone() for k, v in model.state_dict().items()})(mel, toks)
    assert not torch.equal(after, before)
    assert torch.equal(after, want)


def test_transcription_follows_a_checkpoint_loaded_after_load(jax_f32):
    """api.load makes the serving copies; weights loaded into the bundle's
    model afterwards are the ones the generated tokens come from."""
    jm, params = jax_f32
    wcfg = tcfg.WhisperConfig(dtype="bfloat16", prompt_ids=PROMPT, eot_id=EOT, **SMALL)
    cfg = tcfg.ExperimentConfig(model_family="whisper", whisper=wcfg)
    dcfg = tcfg.DecodeConfig(max_decode_len=12)
    bundle = api.load(config=cfg, device="cpu")
    mel = torch.from_numpy(_mel(2, seed=13))
    with torch.no_grad():
        random_init = twg.generate(bundle, mel, dcfg)[0]
        bundle.model.load_state_dict(convert.whisper_params_to_state_dict(params))
        got = twg.generate(bundle, mel, dcfg)[0]
        fresh = type("B", (), {"config": cfg, "model": _port(params, "bfloat16")})()
        want = twg.generate(fresh, mel, dcfg)[0]
    assert not torch.equal(got, random_init)
    assert torch.equal(got, want)


def test_whisper_refuses_adapters_until_their_slice(jax_f32):
    """Adapters are no longer refused (tests/test_torch_whisper_train.py
    holds them against JAX): a WF-adapted Whisper holds an insert on every
    Dense of both stacks (4 projections + fc1/fc2 an encoder block, 4 more a
    decoder block), and at its identity init (B = 0) gives the unadapted
    model's logits from the same backbone."""
    _, params = jax_f32
    cfg = tcfg.WhisperConfig(dtype="float32", **SMALL)
    cfg.adapter = tcfg.AdapterConfig(kind="wf")
    model = WhisperModel(cfg)
    missing, unexpected = model.load_state_dict(convert.whisper_params_to_state_dict(params),
                                                strict=False)
    assert not unexpected and all(".adapter_wf." in k for k in missing)
    assert len(missing) == 3 * (2 * 6 + 2 * 10)
    mel = torch.from_numpy(_mel(2, seed=3))
    toks = torch.from_numpy(np.random.RandomState(4).randint(0, 50, (2, 5)))
    with torch.no_grad():
        np.testing.assert_array_equal(model.eval()(mel, toks).numpy(),
                                      _port(params)(mel, toks).numpy())


# --- tokenizer, bundle --------------------------------------------------------


def _tiny_bpe_files(d):
    import json

    chars = [chr(c) for c in range(ord("a"), ord("z") + 1)] + ["Ġ", "ä", "¸", "Ń"]
    vocab = {c: i for i, c in enumerate(chars)}
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("Ġ", "w"), ("o", "r")]
    for a, b in merges:
        vocab[a + b] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab), encoding="utf-8")
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges),
                                  encoding="utf-8")
    return vocab


def test_bpe_twin_encodes_and_decodes_like_jax(tmp_path):
    _tiny_bpe_files(tmp_path)
    j = jbpe.ByteLevelBPE.from_hf_dir(tmp_path)
    t = tbpe.ByteLevelBPE.from_hf_dir(tmp_path)
    for text in ("hello world", "hell  or<|endoftext|>he", "it's  a\ttest 12", "中文 hello"):
        ids = t.encode(text)
        assert ids == j.encode(text)
        assert t.encode(text, allow_special=False) == j.encode(text, allow_special=False)
        assert t.decode(ids) == j.decode(ids)
        assert t.decode(ids, skip_special=False) == j.decode(ids, skip_special=False)
    text = "it's  a\ttest 12!?"
    assert tbpe.gpt2_pretokenize(text) == jbpe.gpt2_pretokenize(text)
    assert len(t) == len(j)


def test_bundle_transcribes_whisper_on_the_cpu_and_round_trips(jax_f32, tmp_path):
    _, params = jax_f32
    wcfg = tcfg.WhisperConfig(dtype="float32", prompt_ids=PROMPT, eot_id=EOT, **SMALL)
    cfg = tcfg.ExperimentConfig(model_family="whisper", whisper=wcfg)
    cfg.decode.max_decode_len = 10
    bundle = api.load(config=cfg, device="cpu")
    bundle.model.load_state_dict(convert.whisper_params_to_state_dict(params))
    rng = np.random.RandomState(0)
    audio = [0.1 * rng.randn(8000).astype(np.float32), 0.1 * rng.randn(40000).astype(np.float32)]
    bundle.save(str(tmp_path / "b"))
    _tiny_bpe_files(tmp_path / "b")
    loaded = api.load(str(tmp_path / "b"), device="cpu")
    assert isinstance(loaded.tokenizer, tbpe.ByteLevelBPE)
    for key, t in bundle.model.state_dict().items():
        assert torch.equal(t, loaded.model.state_dict()[key]), key
    texts = api.transcribe(loaded, audio)
    assert len(texts) == 2 and all(isinstance(s, str) for s in texts)
    # the chunked 2.5 s request is one 30 s chunk here: same ids as generate
    timed = api.transcribe(loaded, audio, timestamps=True)
    assert ["".join(t["token"] for t in utt) for utt in timed] == texts
    bad = dataclasses.replace(cfg, frontend=tcfg.FrontendConfig(num_mels=128))
    with pytest.raises(ValueError, match="num_mels"):
        api.load(config=bad, device="cpu")


def test_bundle_load_names_the_missing_unigram_tokenizer(tmp_path):
    """A checkpoint whose vocab.json is the JAX package's unigram tokenizer
    loads as the port's UnigramTokenizer (data/unigram.py) with its pieces
    and scores, and encodes as JAX's does; a char vocab.json still loads;
    the bundle saves the unigram vocab back as JAX wrote it."""
    from jiao_liao_speech_recognition_tpu.data.unigram import UnigramTokenizer
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.data.unigram import UnigramTokenizer as TUni

    cfg = tcfg.ExperimentConfig(model_family="whisper", whisper=tcfg.WhisperConfig(
        dtype="float32", prompt_ids=PROMPT, eot_id=EOT, **SMALL))
    api.load(config=cfg, device="cpu").save(str(tmp_path))
    CharTokenizer(["<blank>", "<unk>", "a", "b"]).save(tmp_path / "vocab.json")
    assert api.load(str(tmp_path), device="cpu").tokenizer.vocab == ["<blank>", "<unk>", "a", "b"]
    jtok = UnigramTokenizer(["a", "b", "ab"], [-1.0, -1.5, -2.0])
    jtok.save(tmp_path / "vocab.json")
    loaded = api.load(str(tmp_path), device="cpu")
    assert isinstance(loaded.tokenizer, TUni)
    assert (loaded.tokenizer.vocab, loaded.tokenizer.logprobs) == (jtok.vocab, jtok.logprobs)
    assert loaded.tokenizer.encode("abba c") == jtok.encode("abba c")
    written = (tmp_path / "vocab.json").read_text(encoding="utf-8")
    loaded.save(str(tmp_path / "again"))
    assert (tmp_path / "again" / "vocab.json").read_text(encoding="utf-8") == written


def test_whisper_preset_twin_matches_jax():
    for name in ("tiny", "base", "small", "medium", "large-v2", "large-v3"):
        assert dataclasses.asdict(tcfg.whisper_preset(name)) == \
            dataclasses.asdict(jcfg.whisper_preset(name))
    with pytest.raises(KeyError):
        tcfg.whisper_preset("huge")
