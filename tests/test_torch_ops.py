"""Plain versions of K2 (attention sublayer), K3 (LN+MLP+residual) and K4
(head+argmax) against the JAX package's Pallas kernels, run in interpret
mode on the CPU as the JAX package's own tests run them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.ops import fused_attention as jfa  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops import fused_head as jfh  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops import fused_mlp as jfm  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import fused_attention as tfa  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import fused_head as tfh  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import fused_mlp as tfm  # noqa: E402

# bf16 outputs: both sides round to bf16 at the same points and differ only
# in the order of f32 sums, which can flip a rounding by one ulp; the output
# passes three roundings (product, + residual, + bias)
ULP_BAR = 2.0
# f32 outputs: the same arithmetic without bf16 roundings, sums reordered
F32_BAR = 2e-5
# K4: f32 logits differ only by summation order (~1e-6 at d=128); ids are
# compared wherever the top-2 margin exceeds this
ARGMAX_MARGIN = 1e-3


def bf16_ulps(got, want):
    """max |got - want| in bf16 ulps of the output magnitude max |want|."""
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / ulp)


def _attn_inputs(B, T, d, lens, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, d).astype(np.float32)
    g = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    bl = (0.1 * rng.randn(d)).astype(np.float32)
    ws = [(rng.randn(*s) * 0.05).astype(np.float32)
          for s in ((d, d), (d,), (d, d), (d, d), (d,), (d, d), (d,))]
    return x, [g, bl] + ws, np.asarray(lens, np.int32)


def _to_torch(x, params, lens, dtype):
    return (torch.from_numpy(x).to(dtype), *[torch.from_numpy(p) for p in params],
            torch.from_numpy(lens))


@pytest.mark.parametrize("heads", [2, 4], ids=["dh128", "dh64"])
def test_attention_plain_matches_jax_kernel_bf16(heads):
    x, params, lens = _attn_inputs(3, 80, 256, [80, 41, 1], seed=heads)
    want = jfa.fused_attention_sublayer(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, params), jnp.asarray(lens), heads
    )
    args = _to_torch(x, params, lens, torch.bfloat16)
    got = tfa.attention_sublayer_plain(*args, heads)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 80, 256)
    assert bf16_ulps(got.float().numpy(), np.asarray(want, np.float32)) <= ULP_BAR
    # the wrapper takes exactly the plain version for a CPU tensor
    assert torch.equal(tfa.fused_attention_sublayer(*args, heads), got)


@pytest.mark.parametrize("heads", [2, 4], ids=["dh128", "dh64"])
def test_attention_plain_matches_jax_reference_f32(heads):
    x, params, lens = _attn_inputs(2, 48, 256, [48, 7], seed=10 + heads)
    want = jfa._attn_sublayer_reference(
        jnp.asarray(x), *map(jnp.asarray, params), jnp.asarray(lens), heads, 1e-5
    )
    got = tfa.attention_sublayer_plain(*_to_torch(x, params, lens, torch.float32), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_BAR, rtol=0)


def test_attention_zero_length_row_averages_uniformly():
    """finfo.min masking: a row with no valid keys attends uniformly over
    all T keys (no NaN), as the JAX kernel does."""
    x, params, lens = _attn_inputs(1, 16, 128, [0], seed=3)
    got = tfa.attention_sublayer_plain(*_to_torch(x, params, lens, torch.float32), 1)
    full = tfa.attention_sublayer_plain(
        *_to_torch(x, params, np.asarray([16], np.int32), torch.float32), 1
    )
    assert torch.isfinite(got).all()
    assert not torch.allclose(got, full)
    want = jfa._attn_sublayer_reference(
        jnp.asarray(x), *map(jnp.asarray, params), jnp.asarray(lens), 1, 1e-5
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_BAR, rtol=0)


def _mlp_inputs(B, T, d, mlp, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, d).astype(np.float32)
    params = [(1.0 + 0.1 * rng.randn(d)), 0.1 * rng.randn(d),
              0.05 * rng.randn(d, mlp), 0.05 * rng.randn(mlp),
              0.05 * rng.randn(mlp, d), 0.05 * rng.randn(d)]
    return x, [p.astype(np.float32) for p in params]


@pytest.mark.parametrize("gelu_form", ["tanh", "erf"])
def test_ln_mlp_plain_matches_jax_kernel_bf16(gelu_form):
    x, params = _mlp_inputs(2, 72, 256, 512, seed=20)
    want = jfm.fused_ln_mlp_residual(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, params), 1e-5, gelu_form
    )
    args = (torch.from_numpy(x).to(torch.bfloat16), *map(torch.from_numpy, params))
    got = tfm.ln_mlp_residual_plain(*args, 1e-5, gelu_form)
    assert bf16_ulps(got.float().numpy(), np.asarray(want, np.float32)) <= ULP_BAR
    assert torch.equal(tfm.fused_ln_mlp_residual(*args, 1e-5, gelu_form), got)


@pytest.mark.parametrize("gelu_form", ["tanh", "erf"])
def test_gelu_forms_match_jax(gelu_form):
    h = np.linspace(-6, 6, 4001, dtype=np.float32)
    want = np.asarray(jfm._gelu_f32(jnp.asarray(h), gelu_form))
    got = tfm.gelu_f32(torch.from_numpy(h), gelu_form).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    if gelu_form == "erf":  # the A&S rational is within 1.5e-7 of exact erf
        exact = torch.nn.functional.gelu(torch.from_numpy(h), approximate="none").numpy()
        np.testing.assert_allclose(got, exact, atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        tfm.gelu_f32(torch.from_numpy(h), "relu")


def test_ln_mlp_plain_matches_jax_reference_f32():
    x, params = _mlp_inputs(2, 24, 128, 256, seed=21)
    want = jfm._ln_mlp_reference(jnp.asarray(x), *map(jnp.asarray, params), 1e-5, "tanh")
    got = tfm.ln_mlp_residual_plain(torch.from_numpy(x), *map(torch.from_numpy, params))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_BAR, rtol=0)


def _head_inputs(B, T, d, V, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, d).astype(np.float32)
    w = (rng.randn(d, V) / np.sqrt(d)).astype(np.float32)
    b = (0.1 * rng.randn(V)).astype(np.float32)
    return x, w, b


def test_head_argmax_plain_matches_jax_kernel():
    x, w, b = _head_inputs(2, 40, 128, 300, seed=30)
    want = np.asarray(jfh.fused_head_argmax(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                            jnp.asarray(b)))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tfh.head_argmax_plain(xt, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 40)
    logits = tfh.head_logits(xt, torch.from_numpy(w), torch.from_numpy(b))
    top2 = logits.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) > ARGMAX_MARGIN).numpy()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    assert torch.equal(tfh.fused_head_argmax(xt, torch.from_numpy(w), torch.from_numpy(b)), got)


@pytest.mark.parametrize("first,second", [(3, 290), (130, 250)])
def test_head_argmax_ties_go_to_the_first_index(first, second):
    """Duplicate columns with a dominant bias: every frame ties between
    `first` and `second` (in different 128-column chunks of the CUDA kernel,
    or in the same one); both packages must answer `first`."""
    x, w, b = _head_inputs(2, 16, 128, 300, seed=31)
    w[:, second] = w[:, first]
    b[first] = b[second] = 100.0
    want = np.asarray(jfh.fused_head_argmax(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                            jnp.asarray(b)))
    got = tfh.head_argmax_plain(torch.from_numpy(x).to(torch.bfloat16),
                                torch.from_numpy(w), torch.from_numpy(b)).numpy()
    assert (want == first).all() and (got == first).all()


@pytest.mark.parametrize("which", ["attention", "mlp", "head"])
def test_wrappers_refuse_a_device_they_have_no_kernel_for(which):
    x = torch.empty(1, 8, 128, device="meta", dtype=torch.bfloat16)
    w = torch.empty(128, 128)
    v = torch.empty(128)
    with pytest.raises(ValueError, match="CUDA"):
        if which == "attention":
            tfa.fused_attention_sublayer(x, v, v, w, v, w, w, v, w, v,
                                         torch.ones(1, dtype=torch.int32), 1)
        elif which == "mlp":
            tfm.fused_ln_mlp_residual(x, v, v, w, v, w, v)
        else:
            tfh.fused_head_argmax(x, w, v)


def _wf_insert(rng, d_in, d_out, r=4):
    """Nonzero inserts (B != 0), so the fold changes the weights."""
    return {"a": (0.1 * rng.randn(d_in, r)).astype(np.float32),
            "g": (1.0 + 0.1 * rng.randn(r)).astype(np.float32),
            "b": (0.1 * rng.randn(r, d_out)).astype(np.float32)}


def _jnp_tree(tree):
    return {k: _jnp_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("heads", [2, 4], ids=["dh128", "dh64"])
def test_wf_attention_plain_matches_jax_k7(heads):
    """K7 (attention): the f32 fold then K2's plain version, against the JAX
    fused_attention_sublayer_wf (fold at "highest" precision, then the
    interpret-mode K2 kernel), bf16, under the K2 ulp bar."""
    import jax

    x, params, lens = _attn_inputs(3, 80, 256, [80, 41, 1], seed=40 + heads)
    g, bl, wq, bq, wk, wv, bv, wo, bo = params
    base = {"wq": wq, "bq": bq, "wk": wk, "wv": wv, "bv": bv, "wo": wo, "bo": bo}
    rng = np.random.RandomState(heads)
    wf = {n: _wf_insert(rng, 256, 256) for n in "qkvo"}
    with jax.default_matmul_precision("highest"):
        want = jfa.fused_attention_sublayer_wf(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(g), jnp.asarray(bl), _jnp_tree(base),
            _jnp_tree(wf), heads, 1e-5, 0.5, jnp.asarray(lens))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    args = (xt, torch.from_numpy(g), torch.from_numpy(bl), _torch_tree(base), _torch_tree(wf),
            heads, 1e-5, 0.5, torch.from_numpy(lens))
    got = tfa.attention_sublayer_wf_plain(*args)
    assert bf16_ulps(got.float().numpy(), np.asarray(want, np.float32)) <= ULP_BAR
    assert torch.equal(tfa.fused_attention_sublayer_wf(*args), got)
    # the inserts matter: without them the result moves by many ulps
    plain = tfa.attention_sublayer_plain(xt, *map(torch.from_numpy, params),
                                         torch.from_numpy(lens), heads)
    assert bf16_ulps(plain.float().numpy(), np.asarray(want, np.float32)) > 4 * ULP_BAR


def test_wf_mlp_plain_matches_jax_k7():
    import jax

    x, params = _mlp_inputs(2, 72, 256, 512, seed=50)
    rng = np.random.RandomState(51)
    wf1, wf2 = _wf_insert(rng, 256, 512), _wf_insert(rng, 512, 256)
    with jax.default_matmul_precision("highest"):
        want = jfm.fused_ln_mlp_residual_wf(
            jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, params), _jnp_tree(wf1),
            _jnp_tree(wf2), 1e-5, "tanh", 1.0)
    args = (torch.from_numpy(x).to(torch.bfloat16), *map(torch.from_numpy, params),
            _torch_tree(wf1), _torch_tree(wf2), 1e-5, "tanh", 1.0)
    got = tfm.ln_mlp_residual_wf_plain(*args)
    assert bf16_ulps(got.float().numpy(), np.asarray(want, np.float32)) <= ULP_BAR
    assert torch.equal(tfm.fused_ln_mlp_residual_wf(*args), got)
    plain = tfm.ln_mlp_residual_plain(args[0], *map(torch.from_numpy, params), 1e-5, "tanh")
    assert bf16_ulps(plain.float().numpy(), np.asarray(want, np.float32)) > 4 * ULP_BAR


@pytest.mark.parametrize("which", ["attention", "mlp", "head", "wf_attention", "wf_mlp"])
def test_wrappers_refuse_a_gradient_they_have_no_backward_for(which, monkeypatch):
    """K2/K3/K4/K7 have no backward in the port: off the CPU, a weight that
    needs a gradient raises before any launch. (A meta tensor stands in for
    a CUDA one; the device check is stubbed so the call reaches the guard.)"""
    for mod in (tfa, tfm, tfh):
        monkeypatch.setattr(mod, "check_cuda", lambda *a: None)
    x = torch.empty(1, 8, 128, device="meta", dtype=torch.bfloat16)
    w = torch.zeros(128, 128, requires_grad=True)
    v = torch.zeros(128)
    ins = {"a": torch.zeros(128, 4), "g": torch.ones(4), "b": torch.zeros(4, 128)}
    calls = {
        "attention": lambda: tfa.fused_attention_sublayer(
            x, v, v, w, v, w, w, v, w, v, torch.ones(1, dtype=torch.int32), 1),
        "mlp": lambda: tfm.fused_ln_mlp_residual(x, v, v, w, v, w, v),
        "head": lambda: tfh.fused_head_argmax(x, w, v),
        "wf_attention": lambda: tfa.fused_attention_sublayer_wf(
            x, v, v, {"wq": w, "bq": v, "wk": w, "wv": w, "bv": v, "wo": w, "bo": v},
            {n: ins for n in "qkvo"}, 1, 1e-5, 1.0, torch.ones(1, dtype=torch.int32)),
        "wf_mlp": lambda: tfm.fused_ln_mlp_residual_wf(x, v, v, w, v, w, v, ins, ins, 1e-5,
                                                       "tanh", 1.0),
    }
    with pytest.raises(RuntimeError, match="no backward"):
        calls[which]()
