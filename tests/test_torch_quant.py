"""The port's int8 serving slice against the JAX package: quantize_int8 /
quantize_kv (bitwise), K10 and K11 (plain versions against the JAX Pallas
kernels in interpret mode, long inputs against the JAX XLA functions), K9's
int8 half, ModelBundle.quantize (bitwise), the int8 caches, greedy tokens
of the quantized model in both cache regimes, and the weight bridge. Small
shapes (d=128, 2 heads of 64, V=300, 2 + 2 blocks), the same seeded numpy
inputs on both sides."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.decode import whisper_generate as jwg  # noqa: E402
from jiao_liao_speech_recognition_tpu.models import layers as jlayers  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.bundle import ModelBundle as JBundle  # noqa: E402
from jiao_liao_speech_recognition_tpu.models.whisper import WhisperModel as JWhisper  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops import decode_attention as jda  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops import quant as jq  # noqa: E402
from jiao_liao_speech_recognition_tpu.utils import config as jcfg  # noqa: E402
from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer  # noqa: E402
from jiao_liao_speech_recognition_torch.decode import whisper_generate as twg  # noqa: E402
from jiao_liao_speech_recognition_torch.models import convert, layers  # noqa: E402
from jiao_liao_speech_recognition_torch.models import whisper as twhisper  # noqa: E402
from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import decode_attention as tda  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import quant as tq  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import config as tcfg  # noqa: E402

SMALL = dict(vocab_size=300, d_model=128, encoder_layers=2, decoder_layers=2, num_heads=2,
             mlp_dim=256, max_target_positions=24, use_flash_attention=False)
EOT = 2
PROMPT = (1, 3)
ULP_BAR = 2.0  # bf16 ulps of the output magnitude: the same roundings, sums reordered
# f32 outputs whose only difference is the order of f32 sums
F32_REL_BAR = 1e-5
# teacher-forced f32 logits of the quantized decoder, JAX kernels (interpret)
# against the port's plain versions: bf16 roundings flip by one ulp in
# different places through two blocks; relative to the largest logit
# (0.0053 at these shapes)
LOGIT_REL_BAR = 0.01


def _ulps(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / ulp)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# --- quantize_int8 / quantize_kv -------------------------------------------------


def _quant_inputs():
    rng = np.random.RandomState(0)
    w = (0.07 * rng.randn(64, 48)).astype(np.float32)
    w[:, 5] = 0.0  # a zero channel keeps scale 0
    # a channel whose scale is exactly 1: its .5 values round half to even
    w[:, 7] = np.arange(64) - 31.5
    w[0, 7] = 127.0
    return w


def test_quantize_int8_is_bitwise_jax():
    w = _quant_inputs()
    jqv, js = jq.quantize_int8(jnp.asarray(w))
    q, s = tq.quantize_int8(_t(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[5] == 0 and not q[:, 5].any()
    assert q[1, 7] == -30 and q[2, 7] == -30  # -30.5 and -29.5 to even


def test_quantize_kv_is_bitwise_jax():
    rng = np.random.RandomState(1)
    a = rng.randn(2, 3, 17, 64).astype(np.float32)
    a[0, 1, 4] = 0.0
    a[1, 2, 9] = np.arange(64) - 31.5
    a[1, 2, 9, 0] = 127.0
    jqv, js = jq.quantize_kv(jnp.asarray(a, jnp.bfloat16))
    q, s = tq.quantize_kv(_t(a).to(torch.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[0, 1, 4] == 0 and tuple(s.shape) == (2, 3, 17)


# --- K10 ------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 8, 64])
def test_k10_plain_matches_jax_kernel(rows):
    rng = np.random.RandomState(rows)
    x = _bf16(rng.randn(rows, 200))
    qv, s = jq.quantize_int8(jnp.asarray(0.05 * rng.randn(200, 300), jnp.float32))
    want = np.asarray(jq._int8_matmul_pallas(jnp.asarray(x, jnp.bfloat16), qv, s), np.float32)
    got = tq.int8_gemv(_t(x, torch.bfloat16), _t(qv), _t(s))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (rows, 300)
    assert _ulps(got.float().numpy(), want) <= ULP_BAR
    tq.MATMUL_COUNTER.reset()
    lead = tq.int8_matmul(_t(x, torch.bfloat16).reshape(rows, 1, 200), _t(qv), _t(s))
    assert tuple(lead.shape) == (rows, 1, 300) and torch.equal(lead[:, 0], got)
    assert tq.MATMUL_COUNTER.launches == 0  # CPU tensors take the plain version


def test_k10_long_rows_take_the_jax_xla_function():
    rng = np.random.RandomState(2)
    x = _bf16(rng.randn(5, 13, 200))  # 65 rows > MAX_KERNEL_ROWS
    qv, s = jq.quantize_int8(jnp.asarray(0.05 * rng.randn(200, 300), jnp.float32))
    want = np.asarray(jq._int8_matmul_xla(jnp.asarray(x, jnp.bfloat16), qv, s), np.float32)
    got = tq.int8_matmul(_t(x, torch.bfloat16), _t(qv), _t(s))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (5, 13, 300)
    assert _ulps(got.float().numpy(), want) <= ULP_BAR
    assert tq.MAX_KERNEL_ROWS == jq.MAX_KERNEL_ROWS == 64


@pytest.mark.parametrize("rows", [1, 8, 64, 65])
def test_k10_bias_matches_jax_kernel_then_bias(rows):
    """K10's bias, folded into the launch: the plain version (<= 64 rows)
    and int8_matmul (all rows) against the JAX kernel in interpret mode (its
    XLA function past 64 rows) followed by the JAX caller's
    + bias.astype(bf16) (models/adapters.py, the dense_q branch)."""
    rng = np.random.RandomState(20 + rows)
    x = _bf16(rng.randn(rows, 200))
    qv, s = jq.quantize_int8(jnp.asarray(0.05 * rng.randn(200, 320), jnp.float32))
    bias = (0.5 * rng.randn(320)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    y = jq._int8_matmul_pallas(xj, qv, s) if rows <= 64 else jq._int8_matmul_xla(xj, qv, s)
    want = np.asarray(y + jnp.asarray(bias).astype(jnp.bfloat16), np.float32)
    xt, bt = _t(x, torch.bfloat16), _t(bias).to(torch.bfloat16)
    tq.MATMUL_COUNTER.reset()
    got = tq.int8_matmul(xt, _t(qv), _t(s), bias=bt)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (rows, 320)
    assert _ulps(got.float().numpy(), want) <= ULP_BAR
    if rows <= 64:
        plain = tq.int8_matmul_plain(xt, _t(qv), _t(s), bt)
        assert torch.equal(plain, got) and torch.equal(tq.int8_gemv(xt, _t(qv), _t(s), bt), got)
    assert tq.MATMUL_COUNTER.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows", [3, 70])
@pytest.mark.parametrize("with_bias", [True, False])
def test_int8_dense_equals_the_product_then_the_bias(dtype, rows, with_bias):
    """Int8Dense.forward hands its bias to int8_matmul (folded into K10 for
    bf16 rows) and no longer adds it itself: bit for bit the earlier two
    steps, int8_matmul without a bias and then + bias in x's dtype."""
    rng = np.random.RandomState(rows)
    dt = getattr(torch, dtype)
    w = _t((0.05 * rng.randn(64, 96)).astype(np.float32))
    bias = _t((0.3 * rng.randn(96)).astype(np.float32)) if with_bias else None
    layer = layers.Int8Dense(*tq.quantize_int8(w), bias)
    x = _t(rng.randn(rows, 64).astype(np.float32)).to(dt)
    with torch.no_grad():
        got = layer(x)
    want = tq.int8_matmul(x, layer.kernel_q, layer.scale)
    if with_bias:
        want = want + bias.to(dt)
    assert got.dtype == dt and torch.equal(got, want)


# --- K11 ------------------------------------------------------------------------


def _table(rng, V, D):
    qT, s = jq.quantize_int8(jnp.asarray(rng.randn(V, D) / math.sqrt(D), jnp.float32).T)
    return np.asarray(qT.T), np.asarray(s)


@pytest.mark.parametrize("rows", [3, 64])
def test_k11_plain_matches_jax_kernel(rows):
    rng = np.random.RandomState(13 + rows)
    x = rng.randn(rows, 128).astype(np.float32)
    qv, s = _table(rng, 300, 128)  # V not a multiple of any tile
    want = np.asarray(jq._int8_tied_logits_pallas(jnp.asarray(x), jnp.asarray(qv), jnp.asarray(s)))
    got = tq.int8_logits(_t(x), _t(qv), _t(s))
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, 300)
    assert _rel(got.numpy(), want) <= F32_REL_BAR


def test_k11_long_rows_dequantize_first_like_jax():
    rng = np.random.RandomState(14)
    x = rng.randn(70, 96).astype(np.float32)  # > 64 rows; D not a multiple of 128
    qv, s = _table(rng, 300, 96)
    want = np.asarray(jq._int8_tied_logits_xla(jnp.asarray(x), jnp.asarray(qv), jnp.asarray(s)))
    got = tq.int8_tied_logits(_t(x), _t(qv), _t(s))
    assert _rel(got.numpy(), want) <= F32_REL_BAR
    # the kernel's function scales after the product: a different rounding
    kern = tq.int8_tied_logits_plain(_t(x), _t(qv), _t(s))
    assert 0 < _rel(kern.numpy(), want) < 0.01


# --- K9, int8 half ----------------------------------------------------------------


def _int8_caches(rng, B, H, t_valid, dh):
    kq, ks = jq.quantize_kv(jnp.asarray(rng.randn(B, H, t_valid, dh), jnp.float32))
    vq, vs = jq.quantize_kv(jnp.asarray(rng.randn(B, H, t_valid, dh), jnp.float32))
    return [np.asarray(jda.pad_time_to_tk(a, 2)) for a in (kq, ks, vq, vs)]


@pytest.mark.parametrize("tq_rows", [1, 2, 5])
def test_k9_int8_plain_matches_jax_kernel(tq_rows):
    rng = np.random.RandomState(20 + tq_rows)
    B, H, dh, t_valid = 3, 2, 64, 100
    q = _bf16(rng.randn(B, H, tq_rows, dh))
    kq, ks, vq, vs = _int8_caches(rng, B, H, t_valid, dh)  # padded to 128, scales 0 there
    assert kq.shape[2] == 128 and not ks[:, :, t_valid:].any()
    lens = np.array([0, 1, t_valid], np.int32)
    want = np.asarray(jda.grouped_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(lens),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    tda.INT8_COUNTER.reset()
    got = tda.grouped_decode_attention(_t(q, torch.bfloat16), _t(kq), _t(vq), _t(lens),
                                       k_scale=_t(ks), v_scale=_t(vs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, tq_rows, dh)
    assert np.isfinite(got.numpy()).all()  # the zero-length row: uniform over all keys
    assert _ulps(got.numpy(), want) <= ULP_BAR
    assert tda.INT8_COUNTER.launches == 0
    shim = tq.int8_decode_attention(_t(q, torch.bfloat16), _t(kq[:, :, :t_valid]),
                                    _t(ks[:, :, :t_valid]), _t(vq[:, :, :t_valid]),
                                    _t(vs[:, :, :t_valid]), _t(lens))
    np.testing.assert_array_equal(shim.numpy(), got.numpy())  # the shim pads to 128


def test_k9_int8_rounding_point_against_the_mul_reduce_reference(monkeypatch):
    """The kernel rounds p * vs to bf16 before P.V (the TPU kernel's
    _attend_head); the JAX package's mul-reduce reference keeps it in f32.
    The gap is that one rounding: at most 2^-8 of the output magnitude."""
    rng = np.random.RandomState(30)
    B, H, dh, t_valid = 2, 2, 64, 100
    q = _bf16(rng.randn(B, H, 1, dh))
    kq, ks, vq, vs = _int8_caches(rng, B, H, t_valid, dh)
    lens = np.array([t_valid, 37], np.int32)
    monkeypatch.setattr(jlayers, "_on_tpu", lambda: False)
    ref = np.asarray(jlayers._int8_cross_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(vq), jnp.asarray(vs),
        jnp.asarray(lens), None, jnp.float32))
    got = tda.decode_attention_plain(_t(q, torch.bfloat16), _t(kq), _t(vq), _t(lens),
                                     k_scale=_t(ks), v_scale=_t(vs)).numpy()
    gap = _rel(got, ref)
    assert 0 < gap <= 2.0 ** -8, gap
    # the model's int8 cache attention is that function; it has no mul-reduce
    # path: a bare key mask or more than MAX_TQ query rows raise
    via = layers.int8_cache_attention(_t(q, torch.bfloat16), _t(kq), _t(ks), _t(vq), _t(vs),
                                      _t(lens), None, torch.float32)
    np.testing.assert_array_equal(via.numpy(), got)
    mask = _t(np.arange(128)[None, None, None, :] < lens[:, None, None, None])
    with pytest.raises(ValueError, match="threaded lengths"):
        layers.int8_cache_attention(_t(q), _t(kq), _t(ks), _t(vq), _t(vs), None, mask,
                                    torch.float32)
    q9 = torch.zeros(B, H, tda.MAX_TQ + 1, dh)
    with pytest.raises(ValueError, match="query rows"):
        layers.int8_cache_attention(q9, _t(kq), _t(ks), _t(vq), _t(vs), _t(lens), None,
                                    torch.float32)


def test_k9_int8_needs_both_scales():
    q = torch.zeros(1, 2, 1, 64)
    k = torch.zeros(1, 2, 128, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="both"):
        tda.grouped_decode_attention(q, k, k, torch.tensor([3]), k_scale=torch.ones(1, 2, 128))


# --- the model ------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_bf16():
    cfg = jcfg.WhisperConfig(dtype="bfloat16", **SMALL)
    model = JWhisper(cfg)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 80, 60)),
                        jnp.zeros((1, 4), jnp.int32))["params"]
    jb = JBundle(config=jcfg.ExperimentConfig(model_family="whisper", whisper=cfg),
                 params=params, tokenizer=None)
    return model, params, jb.quantize().params


def _bundle(params):
    wcfg = tcfg.WhisperConfig(dtype="bfloat16", prompt_ids=PROMPT, eot_id=EOT, **SMALL)
    model = twhisper.WhisperModel(wcfg)
    model.load_state_dict(convert.whisper_params_to_state_dict(params))
    model.eval()
    layers.cast_for_serving(model, torch.bfloat16)
    return ModelBundle(tcfg.ExperimentConfig(model_family="whisper", whisper=wcfg), model,
                       CharTokenizer([]))


def _enc(jm, params, seed):
    mel = (np.random.RandomState(seed).randn(2, 80, 60) * 0.3).astype(np.float32)
    enc = jm.apply({"params": params}, jnp.asarray(mel), method=jm.encode)
    return enc, torch.from_numpy(np.asarray(enc, np.float32)).to(torch.bfloat16)


def test_quantize_is_bitwise_jax_and_leaves_the_bundle(jax_bf16):
    _, params, qparams = jax_bf16
    bundle = _bundle(params)
    before = {k: v.clone() for k, v in bundle.model.state_dict().items()}
    qb = bundle.quantize()
    assert qb is not bundle and qb.model is not bundle.model
    assert qb.model.encoder is bundle.model.encoder  # shared, not copied
    want = convert.whisper_params_to_state_dict(qparams)
    got = qb.model.state_dict()
    assert set(got) == set(want)
    for key, t in want.items():
        assert got[key].dtype == t.dtype, key
        assert torch.equal(got[key], t), key
    assert sum(isinstance(m, layers.Int8Dense) for m in qb.model.decoder.modules()) == 2 * 10
    assert not layers.is_quantized(qb.model.encoder)
    assert isinstance(qb.model.decoder.embed_tokens, twhisper.Int8TiedEmbedding)
    after = bundle.model.state_dict()
    assert set(after) == set(before) and all(torch.equal(after[k], v) for k, v in before.items())
    assert not layers.is_quantized(bundle.model)
    assert qb.device == bundle.device


def test_quantize_refuses_the_ctc_family():
    b = ModelBundle(tcfg.ExperimentConfig(), model=None, tokenizer=None)
    with pytest.raises(NotImplementedError, match="whisper"):
        b.quantize()


def test_quantized_tree_round_trips_through_the_bridge(jax_bf16):
    _, params, qparams = jax_bf16
    qmodel = _bundle(params).quantize().model
    state = convert.whisper_params_to_state_dict(qparams)
    qmodel.load_state_dict(state)
    back = convert.flatten_params(convert.whisper_state_dict_to_params(qmodel.state_dict()))
    flat = convert.flatten_params(qparams)
    assert set(back) == set(flat)
    for path, a in flat.items():
        assert back[path].dtype == np.asarray(a).dtype, path
        np.testing.assert_array_equal(back[path], np.asarray(a))
    assert back[("decoder", "block_0", "mlp", "fc1", "dense_q", "kernel_q")].dtype == np.int8


def test_init_cache_int8_layouts(jax_bf16, monkeypatch):
    """Int8 head-major cross caches at every batch (horizon padded to 128,
    scales 0 there); self caches bf16 below batch 16 (packed on the CPU,
    head-major on the card), int8 head-major at 16 or with
    layout="head_major"; tests/test_quant.py's assertions on the JAX side."""
    _, params, _ = jax_bf16
    model = _bundle(params).quantize().model
    enc = _t(np.random.RandomState(13).randn(2, 30, 128).astype(np.float32)).to(torch.bfloat16)
    c = model.init_cache(2, enc, 12)["block_0"]
    cross, self_c = c["cross"], c["self"]
    assert set(cross) == {"k", "k_scale", "v", "v_scale"}
    assert cross["k"].dtype == torch.int8 and tuple(cross["k"].shape) == (2, 2, 128, 64)
    assert cross["v_scale"].dtype == torch.float32 and tuple(cross["v_scale"].shape) == (2, 2, 128)
    assert (cross["k_scale"][:, :, 30:] == 0).all() and (cross["k_scale"][:, :, :30] > 0).all()
    assert set(self_c) == {"k", "v"} and self_c["k"].dtype == torch.bfloat16
    assert tuple(self_c["k"].shape) == (2, 12, 128)
    monkeypatch.setattr(twhisper, "_on_card", lambda t: True)
    card = model.init_cache(2, enc, 12)["block_1"]["self"]
    assert card["k"].dtype == torch.bfloat16 and tuple(card["k"].shape) == (2, 2, 128, 64)
    for batch, layout in ((16, None), (2, "head_major")):
        s = model.init_cache(batch, enc[:1].expand(batch, -1, -1), 12, layout)["block_0"]["self"]
        assert s["k"].dtype == torch.int8 and s["k"].shape[2] % 128 == 0
        assert s["k_scale"].dtype == torch.float32 and not s["k_scale"].any()
    packed = model.init_cache(16, enc[:1].expand(16, -1, -1), 12, "packed")["block_0"]
    assert packed["self"]["k"].dim() == 3 and packed["cross"]["k"].dtype == torch.int8


def _jax_tpu_routes(monkeypatch):
    """The JAX package's TPU dispatch on the CPU: K9 and the int8 kernels
    in interpret mode (rows <= 64), the XLA functions beyond."""
    monkeypatch.setattr(jlayers, "_on_tpu", lambda: True)

    def int8_matmul(x, q, scale):
        lead = x.shape[:-1]
        rows = int(np.prod(lead))
        if rows > jq.MAX_KERNEL_ROWS:
            return jq._int8_matmul_xla(x, q, scale)
        y = jq._int8_matmul_pallas(x.reshape(rows, x.shape[-1]), q, scale)
        return y.reshape(*lead, q.shape[1]).astype(x.dtype)

    def int8_tied_logits(x, q_vd, scale_v):
        if x.shape[0] > jq.MAX_KERNEL_ROWS:
            return jq._int8_tied_logits_xla(x, q_vd, scale_v)
        return jq._int8_tied_logits_pallas(x, q_vd, scale_v)

    monkeypatch.setattr(jq, "int8_matmul", int8_matmul)
    monkeypatch.setattr(jq, "int8_tied_logits", int8_tied_logits)


@pytest.mark.parametrize("regime", ["int8_cross_bf16_self", "card_bf16_self_head_major",
                                    "all_int8"])
def test_greedy_tokens_of_the_quantized_model_match_jax(jax_bf16, monkeypatch, regime):
    """Greedy decode of the quantized model from one encoder output: the
    JAX side on its TPU routes (interpret mode), the port on the plain
    versions of K9 (both halves), K10 and K11. Self caches: packed bf16
    (JAX below batch 16), head-major bf16 (the card below 16; JAX packed),
    int8 head-major (JAX at batch >= 16, forced here)."""
    jm, params, qparams = jax_bf16
    _jax_tpu_routes(monkeypatch)
    layout = None
    if regime == "all_int8":
        monkeypatch.setattr(jlayers, "HEAD_MAJOR_MIN_BATCH", 1)
        layout = "head_major"
    elif regime == "card_bf16_self_head_major":
        monkeypatch.setattr(twhisper, "_on_card", lambda t: True)
    enc, enc_t = _enc(jm, params, seed=7)
    want, want_len = jwg.greedy_from_enc(jm, qparams, enc, None, max_len=16, prompt=PROMPT,
                                         eot_id=EOT)
    model = _bundle(params).quantize().model
    caches = model.init_cache(2, enc_t, 16, layout)
    expect_int8_self = regime == "all_int8"
    assert (caches["block_0"]["self"]["k"].dtype == torch.int8) == expect_int8_self
    for counter in (tq.MATMUL_COUNTER, tq.LOGITS_COUNTER, tda.INT8_COUNTER, tda.COUNTER):
        counter.reset()
    got, got_len = twg.greedy_from_enc(model, enc_t, None, 16, PROMPT, EOT, layout=layout)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert len(set(got.numpy().ravel().tolist())) > 1  # not a constant output
    assert tq.MATMUL_COUNTER.launches == tq.LOGITS_COUNTER.launches == 0  # CPU: plain versions


def test_teacher_forced_logits_and_fidelity(jax_bf16, monkeypatch):
    """The quantized decoder's f32 logits against the JAX package's (K10 /
    K11 in interpret mode), and the JAX fidelity bar against the bf16
    decoder (tests/test_quant.py): top-1 agreement >= 0.9, cosine > 0.999."""
    jm, params, qparams = jax_bf16
    _jax_tpu_routes(monkeypatch)
    enc, enc_t = _enc(jm, params, seed=9)
    toks = np.random.RandomState(10).randint(0, 300, (2, 8)).astype(np.int32)
    want = np.asarray(jm.apply({"params": qparams}, jnp.asarray(toks), enc, method=jm.decode))
    bundle = _bundle(params)
    with torch.no_grad():
        got = bundle.quantize().model.decode(_t(toks), enc_t)
        ref = bundle.model.decode(_t(toks), enc_t).float()
    assert got.dtype == torch.float32 and want.dtype == np.float32  # int8 logits stay f32
    assert _rel(got.numpy(), want) <= LOGIT_REL_BAR
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    cos = float((got * ref).sum() / (got.norm() * ref.norm()))
    assert agree >= 0.9 and cos > 0.999, (agree, cos)


def test_decode_steps_of_the_quantized_model_match_its_teacher_forcing(jax_bf16):
    """With int8 self caches every step reads what teacher forcing computes
    from bf16 K/V rows, within int8 rounding; the plain path (kernels=False)
    is the same function as the kernel route's plain versions on the CPU."""
    _, params, _ = jax_bf16
    model = _bundle(params).quantize().model
    enc_t = _t(np.random.RandomState(12).randn(2, 30, 128).astype(np.float32)).to(torch.bfloat16)
    toks = torch.from_numpy(np.random.RandomState(11).randint(0, 300, (2, 6)))
    with torch.no_grad():
        full = model.decode(toks, enc_t)
        out = {}
        for kernels in (True, False):
            caches = model.init_cache(2, enc_t, 8, "head_major")
            out[kernels] = torch.stack([model.decode_step(toks[:, p:p + 1], p, enc_t, caches,
                                                          kernels=kernels)[0]
                                        for p in range(6)], 1)
    assert torch.equal(out[True], out[False])
    cos = float((out[True] * full).sum() / (out[True].norm() * full.norm()))
    assert cos > 0.999 and (out[True].argmax(-1) == full.argmax(-1)).float().mean() >= 0.9


def test_quantized_bundle_transcribes(jax_bf16):
    _, params, _ = jax_bf16
    qb = _bundle(params).quantize()
    qb.config.decode.max_decode_len = 10
    rng = np.random.RandomState(0)
    texts = qb.transcribe([0.1 * rng.randn(8000).astype(np.float32)])
    assert len(texts) == 1 and isinstance(texts[0], str)
