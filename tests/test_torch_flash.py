"""K6 / K8 plain versions (ops/flash_attention.py of the port) against the
JAX package's flash_attention and flash_attention_packed, whose Pallas
forward (with lse) and backward kernels run in interpret mode on the CPU;
gradients go through jax.grad of the custom_vjp on the JAX side and through
the port's autograd.Function (plain versions on CPU tensors) on the other."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.ops import flash_attention as jfl  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import flash_attention as tfl  # noqa: E402

# f32 inputs at "highest" matmul precision: the same algorithm, sums taken
# in another order (block-wise online softmax against one softmax)
F32_BAR = 2e-5
# lse is f32 on both sides: the same log-sum-exp, summed in another order
LSE_BAR = 1e-5


def _inputs(B, T, H, dh, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, dh).astype(np.float32) for _ in range(4)]


def _t(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


# (T, lens): two 256-key blocks with a ragged edge; a 37-key and a 1-key row
CASES = [(300, [300, 37]), (300, [1, 300])]


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_flash_plain_forward_and_lse_match_jax(dh, causal, case):
    T, lens = CASES[case]
    q, k, v, _ = _inputs(2, T, 2, dh, seed=dh + case)
    lens = np.asarray(lens, np.int32)
    with jax.default_matmul_precision("highest"):
        want, want_lse = jfl._flash_forward(*map(jnp.asarray, (q, k, v, lens)), causal,
                                            with_lse=True)
    got, lse = tfl.flash_forward_plain(*_t(q, k, v), torch.from_numpy(lens), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_BAR, rtol=0)
    want_lse = np.asarray(want_lse).reshape(2 * 2, -1)[:, :T]
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=LSE_BAR, rtol=1e-6)
    # the wrapper takes exactly the plain version for a CPU tensor
    out_w, lse_w = tfl.flash_forward(*_t(q, k, v), torch.from_numpy(lens), causal)
    assert torch.equal(out_w, got) and torch.equal(lse_w, lse)


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_plain_backward_matches_jax_pallas_backward(dh, causal):
    """jax.grad through flash_attention's custom_vjp (interpret-mode K8)
    against torch.autograd through FlashAttention, non-uniform cotangent;
    lengths 300 (ragged second block) and 37."""
    T = 300
    q, k, v, w = _inputs(2, T, 2, dh, seed=7 + dh)
    lens = np.asarray([T, 37], np.int32)

    def f(q, k, v):
        return jnp.sum(jfl.flash_attention(q, k, v, kv_lengths=jnp.asarray(lens),
                                           causal=causal) * jnp.asarray(w))

    with jax.default_matmul_precision("highest"):
        want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = tfl.flash_attention(tq, tk, tv, kv_lengths=torch.from_numpy(lens), causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=F32_BAR * max(1.0, np.abs(ref).max()),
                                   rtol=0, err_msg=f"d{name}")
    # keys past kv_len: exactly zero dK and dV on both sides
    assert np.abs(tk.grad.numpy()[1, 37:]).max() == 0.0
    assert np.abs(tv.grad.numpy()[1, 37:]).max() == 0.0
    assert np.abs(np.asarray(want[1])[1, 37:]).max() == 0.0


def test_flash_packed_matches_jax_packed_with_grads():
    """flash_attention_packed ([B, T, H*dh], dh=128) forward and grads."""
    B, T, H, dh = 2, 300, 2, 128
    rng = np.random.RandomState(11)
    q, k, v, w = [rng.randn(B, T, H * dh).astype(np.float32) for _ in range(4)]
    lens = np.asarray([300, 1], np.int32)

    def f(q, k, v):
        return jnp.sum(jfl.flash_attention_packed(q, k, v, H, kv_lengths=jnp.asarray(lens))
                       * jnp.asarray(w))

    with jax.default_matmul_precision("highest"):
        want_out = np.asarray(jfl.flash_attention_packed(
            *map(jnp.asarray, (q, k, v)), H, kv_lengths=jnp.asarray(lens)))
        want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = tfl.flash_attention_packed(tq, tk, tv, H, kv_lengths=torch.from_numpy(lens))
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=F32_BAR, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=F32_BAR * max(1.0, np.abs(ref).max()),
                                   rtol=0)


def test_flash_mask_form_and_kernels_switch():
    """A [B, 1, 1, Tk] key mask converts to lengths (the JAX rule), and
    kernels=False (the plain-flash path) equals the CPU wrapper's result."""
    q, k, v, _ = _inputs(2, 80, 2, 64, seed=3)
    lens = torch.tensor([80, 30])
    mask = (torch.arange(80)[None, :] < lens[:, None])[:, None, None, :]
    a = tfl.flash_attention(*_t(q, k, v), mask=mask)
    b = tfl.flash_attention(*_t(q, k, v), kv_lengths=lens, kernels=False)
    assert torch.equal(a, b)
    with pytest.raises(NotImplementedError):
        tfl.flash_attention(*_t(q, k, v), mask=torch.ones(2, 1, 80, 80, dtype=torch.bool))


def test_flash_plain_bf16_rounds_p_like_the_kernel():
    """bf16: the plain version rounds P to bf16 before P.V, as the CUDA
    kernel does (the Pallas kernel keeps P in f32). Against the JAX kernel
    in bf16 the output stays within 2 bf16 ulps of its magnitude."""
    q, k, v, _ = _inputs(2, 300, 2, 64, seed=5)
    lens = np.asarray([300, 37], np.int32)
    want = np.asarray(jfl.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                          kv_lengths=jnp.asarray(lens)), np.float32)
    got = tfl.flash_forward_plain(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                                  torch.from_numpy(lens))[0]
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got.float().numpy() - want).max() <= 2 * ulp


def test_flash_wrappers_refuse_what_the_kernels_do_not_take():
    meta = torch.empty(1, 64, 2, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfl.flash_forward(meta, meta, meta, torch.tensor([64]))
    meta96 = torch.empty(1, 64, 2, 96, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head width"):
        tfl.flash_forward(meta96, meta96, meta96, torch.tensor([64]))
