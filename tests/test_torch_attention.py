"""K2 as the card runs it: ln_rows and the q/k/v GEMM (csrc/ln_gemm.cu), the
two-pass attention core (csrc/flash_attention.cu) and the out-projection
GEMM with K2's residual epilogue (csrc/ln_gemm.cu). On the CPU: the plain
version of each launch composes to the sublayer's plain version bit for
bit; a plain-torch emulation of the core's two passes (its own key-tile
width, tiles past kv_len skipped, the zero-length row's uniform case)
agrees with the JAX package's Pallas kernel in interpret mode; and the
route that decides which shapes take K2."""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.ops import fused_attention as jfa  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import fused_attention as tfa  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import fused_mlp as tfm  # noqa: E402

# bf16 outputs: the emulation and the JAX kernel round to bf16 at the same
# points and differ in the order of f32 sums (and exp2 of pre-scaled
# scores against exp), which can flip a rounding by one ulp; the output
# passes three roundings (product, + residual, + bias)
ULP_BAR = 2.0
NEG = -1e30  # the core's mask value (csrc/flash_attention.cu)


def bf16_ulps(got, want):
    """max |got - want| in bf16 ulps of the output magnitude max |want|."""
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / ulp)


def _inputs(B, T, d, lens, seed):
    """x [B, T, d] (bf16 values), LN scale and bias, wq, bq, wk, wv, bv, wo,
    bo (f32), lens, from numpy."""
    rng = np.random.RandomState(seed)
    x = np.array(jnp.asarray(rng.randn(B, T, d), jnp.bfloat16).astype(jnp.float32))
    params = [1.0 + 0.1 * rng.randn(d), 0.1 * rng.randn(d)] + [
        0.05 * rng.randn(*s) for s in ((d, d), (d,), (d, d), (d, d), (d,), (d, d), (d,))]
    return x, [p.astype(np.float32) for p in params], np.asarray(lens, np.int32)


def _core_consts():
    src = (Path(tfa.__file__).parents[1] / "csrc" / "flash_attention.cu").read_text()
    return {n: int(v) for n, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def _core_keys():
    """csrc/flash_attention.cu's key-tile width of the attention core."""
    return _core_consts()["kCoreKeys"]


def test_core_tile_constant_is_the_kernel_source():
    """ops/fused_attention.py's CORE_KEYS (chip_smoke.py's executed-flop
    count pads rows and keys by it) is the core's kCoreKeys and its block's
    kRows."""
    consts = _core_consts()
    assert consts["kCoreKeys"] == consts["kRows"] == tfa.CORE_KEYS


def _emulate_core(qkv, lens, num_heads, tile):
    """The core's two passes on qkv [B, T, 3D] (bf16): per key tile of
    `tile`, S in f32, keys at or past the row's key count at NEG (a row
    with kv_len = 0 takes all T keys with scores 0), tiles past it
    skipped; pass 1 keeps the online max and the sum of exp2((s - m) c),
    pass 2 forms p = exp2((s - m) c) * (1 / sum), rounds it to bf16 and
    accumulates P.V in f32; the heads' output rounded to bf16."""
    B, T, D3 = qkv.shape
    D = D3 // 3
    dh = D // num_heads
    c = np.float32(tfa.attention_scale(dh)) * np.float32(math.log2(math.e))
    q, k, v = (qkv[..., i * D:(i + 1) * D].float().reshape(B, T, num_heads, dh)
               .transpose(1, 2) for i in range(3))  # [B, H, T, dh]
    out = torch.zeros(B, num_heads, T, dh)
    for b in range(B):
        kv = min(int(lens[b]), T)
        uniform = kv == 0
        n_keys = T if uniform else kv
        tiles = [slice(k0, min(k0 + tile, T)) for k0 in range(0, n_keys, tile)]

        def scores(ks):
            with tfa.full_f32():
                s = q[b] @ k[b, :, ks].transpose(-1, -2)
            key = torch.arange(ks.start, ks.stop)
            if uniform:
                s = torch.zeros_like(s)
            return torch.where(key < n_keys, s, torch.tensor(NEG))

        m = torch.full((num_heads, T, 1), NEG)
        l = torch.zeros(num_heads, T, 1)
        for ks in tiles:
            s = scores(ks)
            mt = torch.maximum(m, s.amax(-1, keepdim=True))
            l = l * torch.exp2((m - mt) * c) + torch.exp2(s * c - mt * c).sum(-1, keepdim=True)
            m = mt
        inv = 1.0 / l
        o = torch.zeros(num_heads, T, dh)
        for ks in tiles:
            p = (torch.exp2(scores(ks) * c - m * c) * inv).to(torch.bfloat16).float()
            with tfa.full_f32():
                o = o + p @ v[b, :, ks]
        out[b] = o
    return out.to(torch.bfloat16).transpose(1, 2).reshape(B, T, D)


def _launch_plains(xt, g, bl, wq, bq, wk, wv, bv, wo, bo, lens, heads, core):
    ln = tfm.ln_rows_plain(xt, g, bl, 1e-5)
    qkv = tfm.qkv_gemm_plain(ln, *tfm.pack_qkv(wq, bq, wk, wv, bv))
    attn = core(qkv, lens, heads)
    return tfa.attn_out_residual_plain(xt, attn, wo, bo)


# --- (a) the four launches compose to the sublayer, bit for bit ---------------


@pytest.mark.parametrize("heads", [4, 8], ids=["4x128", "8x64"])
def test_k2_launches_compose_to_the_sublayer_bitwise(heads):
    """ln_rows, the q/k/v GEMM, the core, the out-projection: every rounding
    point between them is a bf16 tensor, so the split changes no bit (d=512,
    ragged lengths including 0 and 1)."""
    x, params, lens = _inputs(4, 40, 512, [40, 0, 1, 23], seed=heads)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    p = [torch.from_numpy(a) for a in params]
    lt = torch.from_numpy(lens)
    got = _launch_plains(xt, *p, lt, heads, tfa.attention_core_plain)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (4, 40, 512)
    assert torch.equal(got, tfa.attention_sublayer_plain(xt, *p, lt, heads))


# --- (b) the core's two passes, emulated, against the JAX kernel ---------------


@pytest.mark.parametrize("heads", [2, 4], ids=["dh128", "dh64"])
def test_core_emulation_matches_jax_kernel(heads):
    """The emulated core between the plain LN + q/k/v and out-projection,
    within 2 bf16 ulps of JAX's fused_attention_sublayer (interpret mode:
    the whole-sublayer kernel at dh 128, the head-group split at dh 64).
    T = 256, the JAX kernel's block, so its zero-length row averages over
    the same T keys as the card's; lens 0, 1, a tile edge and ragged."""
    tile = _core_keys()
    lens = [256, 0, 1, tile, 137]
    x, params, lens = _inputs(len(lens), 256, 256, lens, seed=30 + heads)
    want = jfa.fused_attention_sublayer(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, params), jnp.asarray(lens), heads)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    p = [torch.from_numpy(a) for a in params]
    got = _launch_plains(xt, *p, lens, heads,
                         lambda qkv, ln_, h: _emulate_core(qkv, ln_, h, tile))
    assert bf16_ulps(got.float().numpy(), np.asarray(want, np.float32)) <= ULP_BAR
    # the zero-length row is the uniform average, not zeros (K6's answer)
    plain = tfa.attention_sublayer_plain(xt, *p, torch.from_numpy(lens), heads)
    assert bf16_ulps(got[1].float().numpy(), plain[1].float().numpy()) <= ULP_BAR


def test_core_emulation_skips_tiles_past_kv_len_exactly():
    """With kv_len >= 1, keys past it contribute exactly 0 (exp of NEG
    underflows): the emulation over all T keys and over kv_len keys alone
    give the same bits."""
    tile = _core_keys()
    rng = np.random.RandomState(5)
    T, heads = 3 * tile, 2
    qkv = torch.from_numpy(rng.randn(1, T, 3 * 128).astype(np.float32)).to(torch.bfloat16)
    short = _emulate_core(qkv, [tile + 3], heads, tile)
    cut = _emulate_core(qkv[:, :tile + 3], [tile + 3], heads, tile)
    assert torch.equal(short[:, :tile + 3], cut)


# --- (c) the route ------------------------------------------------------------


def test_route_keeps_k2_below_1280_and_whisper_on_k5_k6(monkeypatch):
    """attention_sublayer_fits, which models/layers.py reads to route a
    block, and the wrapper's refusal of d=1280 before any launch (a meta
    tensor stands in for a CUDA one)."""
    calls = []
    monkeypatch.setattr(tfa, "check_cuda", lambda *a: None)
    monkeypatch.setattr(tfa, "launch", lambda *a: calls.append(a))
    assert tfa.attention_sublayer_fits(512, 4) and tfa.attention_sublayer_fits(512, 8)
    assert tfa.attention_sublayer_fits(1024, 8)
    assert not tfa.attention_sublayer_fits(1280, 20)  # large-v3: K5 -> K6 -> K2h-out
    assert not tfa.attention_sublayer_fits(512, 16)  # dh 32: no core instance
    assert not tfa.attention_sublayer_fits(192, 3)  # d % 128
    meta = torch.empty(1, 8, 1280, device="meta", dtype=torch.bfloat16)
    w = torch.zeros(1280, 1280)
    with pytest.raises(ValueError, match="unsupported attention shape"):
        tfa.fused_attention_sublayer(meta, torch.ones(1280), torch.zeros(1280), w, w[0], w, w,
                                     w[0], w, w[0], torch.ones(1, dtype=torch.int32), 20)
    assert not calls


# --- (d) the core's shared memory ---------------------------------------------


def test_core_shared_memory_fits_at_both_head_widths():
    """The Q tile, kStages stages of a K and a V tile and the barriers, from
    a 1024-aligned base, within the 227 KB a block may take, at both head
    widths of the core."""
    from jiao_liao_speech_recognition_torch import _build

    c = _core_consts()
    for dh in tfa.HEAD_WIDTHS:
        tile = c["kRows"] * dh * 2
        smem = 1024 + tile + c["kStages"] * 2 * tile + (2 + 2 * c["kStages"]) * 8
        assert smem <= _build.SMEM_LIMIT
