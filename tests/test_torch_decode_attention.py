"""K9's and K11's Hopper kernels on the CPU, against the JAX package.

K9 (csrc/decode_attention.cu) streams each (b, h)'s keys in block steps of
128 (bf16) or 256 (int8) keys: its plain version is held against the JAX
package's ``grouped_decode_attention`` (its Pallas kernel in interpret
mode) at lengths around those steps, and the wrapper's shared-memory rule
is pinned. Both kernels turn int8 into f32 and bf16 by a byte permute into
2^23 and a subtraction (common.cuh::int8x4_to_f32 / int8x4_to_bf16x4): a
numpy twin checks every byte bit for bit. K11's persistent schedule (tiles
of 32 vocab rows, a contiguous share of them a block, stages of one
64-column box a k part, the parts summed in order) is emulated to show it
covers every (row, column) once."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.ops import decode_attention as jda  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops import quant as jq  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import decode_attention as tda  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import quant as tq  # noqa: E402

ULP_BAR = 2.0  # bf16 ulps of the output magnitude: the same roundings, sums reordered
F32_REL_BAR = 1e-5  # f32 sums in another order
B, H, DH, TK = 6, 2, 64, 384
# zero, one key, around the bf16 (128) and int8 (256) block steps, the horizon
LENS = [0, 1, 127, 129, 257, 384]


def _ulps(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / ulp)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("tq_rows", [1, 3, 8])
def test_k9_plain_matches_jax_kernel_around_the_block_steps(tq_rows, int8):
    rng = np.random.RandomState(10 * tq_rows + int8)
    q = np.array(jnp.asarray(rng.randn(B, H, tq_rows, DH), jnp.bfloat16).astype(jnp.float32))
    if int8:
        (kq, ks), (vq, vs) = (jq.quantize_kv(jnp.asarray(rng.randn(B, H, TK, DH), jnp.float32))
                              for _ in range(2))
        cache, scales = (kq, vq), {"k_scale": ks, "v_scale": vs}
    else:
        cache = tuple(jnp.asarray(rng.randn(B, H, TK, DH), jnp.bfloat16) for _ in range(2))
        scales = {}
    want = np.asarray(jda.grouped_decode_attention(
        jnp.asarray(q, jnp.bfloat16), *cache, jnp.asarray(LENS, jnp.int32), **scales))
    tc = [torch.from_numpy(np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a))
          for a in cache]
    if not int8:
        tc = [a.to(torch.bfloat16) for a in tc]
    tscales = {k: torch.from_numpy(np.array(v)) for k, v in scales.items()}
    got = tda.grouped_decode_attention(torch.from_numpy(q), *tc,
                                       torch.tensor(LENS, dtype=torch.int32), **tscales)
    assert np.isfinite(got.numpy()).all()  # the zero-length row averages all keys
    assert _ulps(got.numpy(), want) <= ULP_BAR


def test_k9_shared_memory_rule():
    # [Tq'][Tk] f32 scores, 8 warps' partials and P.V partials at dh 128,
    # and [Tk] f32 value scales: one block a (b, h)
    assert tda.decode_attention_fits(1536, 8) and tda.decode_attention_fits(4096)
    assert tda.decode_attention_fits(24576, 1) and not tda.decode_attention_fits(28672, 1)
    assert not tda.decode_attention_fits(8192, 8)


# --- the exact int8 conversions ------------------------------------------------


def test_int8_to_f32_and_bf16_by_byte_permute_is_exact_for_every_byte():
    b = np.arange(-128, 128, dtype=np.int64).astype(np.int8)
    u = b.view(np.uint8).astype(np.uint32) ^ 0x80  # sign flipped: b + 128
    f = (np.uint32(0x4B000000) | u).view(np.float32) - np.float32(8388736.0)
    assert f.dtype == np.float32
    np.testing.assert_array_equal(f.view(np.uint32), b.astype(np.float32).view(np.uint32))
    hi = (f.view(np.uint32) >> 16).astype(np.uint16)  # bf16: the high halves
    assert not (f.view(np.uint32) & 0xFFFF).any()  # nothing is cut off
    want = torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(hi.view(np.int16), want)


def test_int8x4_words_pack_the_lower_byte_into_the_lower_half():
    """int8x4_to_bf16x4 of a word holding bytes b0..b3 (b0 lowest) gives
    (b1 << 16 | b0, b3 << 16 | b2) in bf16 bits: the mma fragments' order."""
    rng = np.random.RandomState(1)
    words = rng.randint(-128, 128, (64, 4)).astype(np.int8)
    w = words.view(np.uint32)[:, 0]
    u = w ^ np.uint32(0x80808080)
    f = [((u >> (8 * i)) & 0xFF | 0x4B000000).astype(np.uint32).view(np.float32)
         - np.float32(8388736.0) for i in range(4)]
    bits = [(x.view(np.uint32) >> 16) for x in f]
    lo, hi = bits[0] | (bits[1] << 16), bits[2] | (bits[3] << 16)
    want = torch.from_numpy(words.astype(np.float32)).to(torch.bfloat16).view(torch.int16)
    want = want.numpy().view(np.uint16).astype(np.uint32)
    np.testing.assert_array_equal(lo, want[:, 0] | (want[:, 1] << 16))
    np.testing.assert_array_equal(hi, want[:, 2] | (want[:, 3] << 16))


# --- K11's persistent schedule ---------------------------------------------------


def _k11_schedule(x, q, s, sms):
    """K11's TMA kernel's walk in plain PyTorch: blocks take contiguous
    shares of the ceil(V / 32) tiles; a tile is walked in stages of one
    64-column box (zero past V and D) for each of its k parts (eight for up
    to 16 rows of x, four above), box j of a stage by part j; each part's
    partial over its boxes, then the parts summed in part order and scaled.
    -> (logits, visits [V, D] of each table entry)."""
    R, D = x.shape
    V = q.shape[0]
    parts = 8 if R <= 16 else 4
    tiles, nchunks = -(-V // 32), -(-D // 64)
    grid = min(sms, tiles)
    xf = x.to(torch.bfloat16).float()
    out = torch.zeros(R, V)
    visits = torch.zeros(V, D, dtype=torch.int32)
    for blk in range(grid):
        for tile in range(blk * tiles // grid, (blk + 1) * tiles // grid):
            rows = torch.arange(tile * 32, min(tile * 32 + 32, V))
            part = torch.zeros(parts, R, len(rows))
            for c0 in range(0, nchunks, parts):
                for j in range(min(parts, nchunks - c0)):
                    cols = torch.arange((c0 + j) * 64, min((c0 + j) * 64 + 64, D))
                    visits[rows[:, None], cols[None, :]] += 1
                    part[j] += xf[:, cols] @ q[rows][:, cols].float().T
            acc = part[0]
            for j in range(1, parts):  # part order
                acc = acc + part[j]
            out[:, rows] = acc * s[rows]
    return out, visits


@pytest.mark.parametrize("R,V,D,sms", [(16, 1000, 1280, 132), (7, 301, 208, 4),
                                       (64, 77, 128, 132), (3, 2049, 320, 9),
                                       (32, 500, 1280, 7)])
def test_k11_schedule_covers_the_table_once(R, V, D, sms):
    rng = np.random.RandomState(R + V)
    x = torch.from_numpy(rng.randn(R, D).astype(np.float32))
    q = torch.from_numpy(rng.randint(-128, 128, (V, D)).astype(np.int8))
    s = torch.from_numpy((0.01 * rng.rand(V)).astype(np.float32))
    got, visits = _k11_schedule(x, q, s, sms)
    assert bool((visits == 1).all())
    want = tq.int8_tied_logits_plain(x, q, s)
    assert float((got - want).abs().max() / want.abs().max()) <= F32_REL_BAR
