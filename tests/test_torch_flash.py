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


# --- the Hopper kernels' rounding points, emulated in plain torch -----------
#
# csrc/flash_attention.cu cannot run on the CPU. These emulate where it
# rounds: the forward's online softmax over key tiles of its own width, with
# P rounded to bf16 at the running max (not the final one) before P.V; the
# backward's P and dS as bf16 hi + lo operands; bf16 outputs. They are held
# to the card's bars (chip_smoke.py): out within 2 bf16 ulps of its
# magnitude and lse within 1e-3 of the JAX Pallas kernel in f32, each
# gradient within 1% of its largest magnitude of the f32 plain backward.
ULP_BAR = 2.0
CHIP_LSE_BAR = 1e-3
GRAD_REL_BAR = 0.01


def test_tile_constants_are_the_kernel_sources():
    """ops/flash_attention.py's BLOCK_ROWS, FWD_KEYS and BWD_TILE (read by
    the emulation below, the scratch size and chip_smoke.py's flop counts)
    are csrc/flash_attention.cu's kRows, kFwdKeys and kBox."""
    import re
    from pathlib import Path

    src = (Path(tfl.__file__).parents[1] / "csrc" / "flash_attention.cu").read_text()
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kRows"], consts["kFwdKeys"], consts["kBox"]) == (
        tfl.BLOCK_ROWS, tfl.FWD_KEYS, tfl.BWD_TILE)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate_forward(q, k, v, lens, causal, tile):
    """The kernel's forward on bf16-valued f32 [B, T, H, dh] tensors."""
    B, Tq, H, dh = q.shape
    Tk = k.shape[1]
    scale = tfl._scale(dh)
    valid = tfl._valid(torch.as_tensor(lens), Tq, Tk, causal, q.device)  # [B, 1, Tq, Tk]
    m = torch.full((B, H, Tq, 1), tfl.NEG)
    l = torch.zeros(B, H, Tq, 1)
    o = torch.zeros(B, H, Tq, dh)
    for k0 in range(0, max(lens), tile):
        ks = slice(k0, min(k0 + tile, Tk))
        with tfl.full_f32():
            s = torch.einsum("bqhd,bkhd->bhqk", q, k[:, ks]) * scale
        s = torch.where(valid[..., ks], s, tfl.NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        with tfl.full_f32():
            o = o * alpha + torch.einsum("bhqk,bkhd->bhqd", _bf16(p), v[:, ks])
        m = m_new
    out = _bf16(o / l.clamp_min(1e-30)).permute(0, 2, 1, 3)
    lse = torch.where(m <= tfl.NEG, tfl.NEG, m) + torch.log(l.clamp_min(1e-30))
    return out, lse.reshape(B * H, Tq)


def _split(x):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _emulate_backward(q, k, v, lens, out, lse, dout, causal):
    """The kernel's backward: f32 S, dP, P and dS; P and dS into their
    products as bf16 hi + lo; bf16 dQ, dK, dV."""
    B, Tq, H, dh = q.shape
    scale = tfl._scale(dh)
    valid = tfl._valid(torch.as_tensor(lens), Tq, k.shape[1], causal, q.device)
    lse4 = lse.reshape(B, H, Tq, 1).clamp_min(tfl.LSE_FLOOR)
    with tfl.full_f32():
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        p = torch.where(valid, torch.exp(s - lse4), 0.0)
        delta = (dout * out).sum(-1).permute(0, 2, 1)[..., None]
        ds = p * (torch.einsum("bqhd,bkhd->bhqk", dout, v) - delta)
        (p_hi, p_lo), (ds_hi, ds_lo) = _split(p), _split(ds)
        dq = (torch.einsum("bhqk,bkhd->bqhd", ds_hi, k)
              + torch.einsum("bhqk,bkhd->bqhd", ds_lo, k)) * scale
        dk = (torch.einsum("bhqk,bqhd->bkhd", ds_hi, q)
              + torch.einsum("bhqk,bqhd->bkhd", ds_lo, q)) * scale
        dv = (torch.einsum("bhqk,bqhd->bkhd", p_hi, dout)
              + torch.einsum("bhqk,bqhd->bkhd", p_lo, dout))
    return _bf16(dq), _bf16(dk), _bf16(dv)


def _ulps(got, want):
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return np.abs(got - want).max() / ulp


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_forward_rounding_matches_jax_pallas_forward(dh, causal, case):
    """Online softmax over the kernel's key tiles (lengths that cut a tile),
    P rounded at the running max, against the Pallas forward in f32."""
    T, lens = CASES[case]
    q, k, v, _ = (_bf16(t) for t in _t(*_inputs(2, T, 2, dh, seed=40 + dh + case)))
    with jax.default_matmul_precision("highest"):
        want, want_lse = jfl._flash_forward(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                            jnp.asarray(lens, jnp.int32), causal, with_lse=True)
    got, lse = _emulate_forward(q, k, v, lens, causal, tfl.FWD_KEYS)
    assert _ulps(got.numpy(), np.asarray(want)) <= ULP_BAR
    want_lse = np.asarray(want_lse).reshape(2 * 2, -1)[:, :T]
    assert np.abs(lse.numpy() - want_lse).max() <= CHIP_LSE_BAR


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_kernel_backward_hi_lo_matches_f32_plain_backward(dh, causal, case):
    """dQ, dK, dV with P and dS as bf16 hi + lo pairs against the f32 plain
    backward on the same bf16 out / lse / dout; padded keys exactly zero."""
    T, lens = CASES[case]
    q, k, v, w = (_bf16(t) for t in _t(*_inputs(2, T, 2, dh, seed=50 + dh + case)))
    out, lse = tfl.flash_forward_plain(q, k, v, torch.tensor(lens), causal)
    out = _bf16(out)
    got = _emulate_backward(q, k, v, lens, out, lse, w, causal)
    want = tfl.flash_backward_plain(q, k, v, torch.tensor(lens), out, lse, w, causal)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert (g - r).abs().max() <= GRAD_REL_BAR * r.abs().max(), name
    for b, n in enumerate(lens):
        if n < T:
            assert got[1][b, n:].abs().max() == 0.0 and got[2][b, n:].abs().max() == 0.0


def _meta(shape, strides, offset=0):
    n = offset + 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    base = torch.empty(n, device="meta", dtype=torch.bfloat16)
    return base.as_strided(shape, strides, offset)


# (layout, the refusal): each a [B, T, H, dh] view that the 4-D tensor maps
# of the kernels cannot take
REFUSED = {
    "time stride not 16 bytes": ((2, 64, 2, 64), (64 * 132, 132, 64, 1), 0, "16-byte"),
    "batch stride not 16 bytes": ((2, 64, 2, 64), (8196, 128, 64, 1), 0, "16-byte"),
    "data 8 bytes off": ((2, 64, 2, 64), (8192, 128, 64, 1), 4, "16-byte"),
    "heads strided": ((2, 64, 2, 64), (16384, 256, 128, 1), 0, "heads"),
    "dh strided": ((2, 64, 2, 64), (16384, 256, 1, 2), 0, "heads"),
    "batch broadcast": ((2, 64, 2, 64), (0, 128, 64, 1), 0, "tensor map"),
    "stride of 2^39": ((2, 64, 2, 64), (2 ** 39, 128, 64, 1), 0, "tensor map"),
    "time stride of 2^39": ((2, 64, 2, 64), (8192, 2 ** 39, 64, 1), 0, "tensor map"),
    "no time steps": ((2, 0, 2, 64), (8192, 128, 64, 1), 0, "empty"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_flash_wrappers_refuse_layouts_the_tensor_maps_cannot_take(name):
    shape, strides, offset, match = REFUSED[name]
    bad = _meta(shape, strides, offset)
    good = _meta(shape[:1] + (max(shape[1], 1),) + shape[2:], (8192, 128, 64, 1))
    lens = torch.tensor([64, 64])
    with pytest.raises(ValueError, match=match):
        tfl.flash_forward(bad, good, good, lens)
    with pytest.raises(ValueError, match=match):
        tfl.flash_forward(good, bad, bad, lens)
    with pytest.raises(ValueError, match=match):
        tfl.flash_backward(bad, good, good, lens, good, torch.empty(4, 64, device="meta"),
                           good)


@pytest.mark.parametrize("saved", ["out", "dout"])
def test_flash_backward_refuses_misaligned_saved_tensors(saved):
    """out and dout are read as 16-byte vectors: a contiguous view at an
    offset that is not 16-byte aligned is refused before any launch."""
    good = _meta((2, 64, 2, 64), (8192, 128, 64, 1))
    tensors = {"out": good, "dout": good, saved: _meta((2, 64, 2, 64), (8192, 128, 64, 1), 4)}
    with pytest.raises(ValueError, match=f"{saved}: rows must be 16-byte aligned"):
        tfl.flash_backward(good, good, good, torch.tensor([64, 64]), tensors["out"],
                           torch.empty(4, 64, device="meta"), tensors["dout"])


def test_flash_wrappers_take_every_layout_the_tensor_maps_take():
    """Head-packed q/k/v slices of one [B, T, 3, H, dh] tensor, a batch of
    one whose batch stride is never stepped, and a time stride past 2^31
    (passed to the kernels as a 64-bit integer) pass every layout check and
    stop only at the device (meta here, CUDA on the card)."""
    from jiao_liao_speech_recognition_torch._build import SIGNATURES, L

    qkv = _meta((2, 64, 3, 2, 64), (64 * 384, 384, 128, 64, 1))
    q, k, v = qkv.unbind(2)
    one = _meta((1, 64, 2, 64), (12, 128, 64, 1))
    wide = _meta((1, 2, 2, 64), (8, 2 ** 31 + 128, 64, 1))
    for args in ((q, k, v), (one, one, one), (wide, wide, wide)):
        with pytest.raises(ValueError, match="CUDA"):
            tfl.flash_forward(*args, torch.tensor([64] * args[0].shape[0]))
    assert tfl.stats_rows(750) == 768 and tfl.stats_rows(128) == 128
    for name in ("jl_flash_fwd", "jl_flash_bwd"):  # q, k, v: pointer, batch, time stride
        assert [SIGNATURES[name][3 * i + j] for i in range(3) for j in (1, 2)] == [L] * 6
