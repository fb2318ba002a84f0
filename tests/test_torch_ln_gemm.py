"""K3 (K3c at d=1280) and K5 as csrc/ln_gemm.cu runs them: an LN pass, then
GEMMs with the bias, GELU and residual in their epilogues. On the CPU: the
plain version of each launch composes to the sublayer's plain version bit
for bit; the sublayer's plain versions agree with the JAX package's Pallas
kernels (the chunked K3c and the LN+QKV kernel, in interpret mode) at
large-v3's width; and the wrappers' shape rules and launch arguments, on
meta tensors that stand in for CUDA ones."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from jiao_liao_speech_recognition_tpu.ops import fused_mlp as jfm  # noqa: E402
from jiao_liao_speech_recognition_torch import _build  # noqa: E402
from jiao_liao_speech_recognition_torch.models import layers  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import fused_attention as tfa  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import fused_mlp as tfm  # noqa: E402

# bf16 outputs: both sides round to bf16 at the same points and differ only
# in the order of f32 sums, which can flip a rounding by one ulp; the
# residual's order differs too (x + (fc2 + b2) here, (x + fc2) + b2 in K3c)
ULP_BAR = 2.0


def bf16_ulps(got, want):
    """max |got - want| in bf16 ulps of the output magnitude max |want|."""
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / ulp)


def _mlp_inputs(T, d, mlp, seed):
    """x [1, T, d] (bf16 values) and the f32 LN + MLP parameters, from numpy."""
    rng = np.random.RandomState(seed)
    x = np.array(jnp.asarray(rng.randn(1, T, d), jnp.bfloat16).astype(jnp.float32))
    params = [1.0 + 0.1 * rng.randn(d), 0.1 * rng.randn(d), 0.05 * rng.randn(d, mlp),
              0.05 * rng.randn(mlp), 0.05 * rng.randn(mlp, d), 0.05 * rng.randn(d)]
    return x, [p.astype(np.float32) for p in params]


def _qkv_inputs(T, d, seed):
    """x [1, T, d] (bf16 values), LN scale and bias, wq, bq, wk, wv, bv (f32)."""
    rng = np.random.RandomState(seed)
    x = np.array(jnp.asarray(rng.randn(1, T, d), jnp.bfloat16).astype(jnp.float32))
    params = [1.0 + 0.1 * rng.randn(d), 0.1 * rng.randn(d), 0.05 * rng.randn(d, d),
              0.1 * rng.randn(d), 0.05 * rng.randn(d, d), 0.05 * rng.randn(d, d),
              0.1 * rng.randn(d)]
    return x, [p.astype(np.float32) for p in params]


# --- (a) the launches compose to the sublayer, bit for bit ---------------------


@pytest.mark.parametrize("d,mlp,gelu_form", [(256, 512, "tanh"), (1280, 5120, "erf")])
def test_mlp_launches_compose_to_the_sublayer_bitwise(d, mlp, gelu_form):
    """ln_rows, fc1 + GELU, fc2 + residual: every rounding point of the
    sublayer is a bf16 tensor, so splitting it changes no bit (B=1, T=40: a
    ragged row count)."""
    x, (g, bl, w1, b1, w2, b2) = _mlp_inputs(40, d, mlp, seed=d)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    g, bl, w1, b1, w2, b2 = map(torch.from_numpy, (g, bl, w1, b1, w2, b2))
    ln = tfm.ln_rows_plain(xt, g, bl, 1e-5)
    h = tfm.fc1_gelu_plain(ln, w1, b1, gelu_form)
    got = tfm.fc2_residual_plain(xt, h, w2, b2)
    assert ln.dtype == h.dtype == got.dtype == torch.bfloat16 and tuple(h.shape) == (1, 40, mlp)
    assert torch.equal(got, tfm.ln_mlp_residual_plain(xt, g, bl, w1, b1, w2, b2, 1e-5, gelu_form))


@pytest.mark.parametrize("d", [256, 1280])
def test_qkv_launches_compose_to_the_sublayer_bitwise(d):
    x, (g, bl, *w) = _qkv_inputs(40, d, seed=d + 1)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    g, bl = torch.from_numpy(g), torch.from_numpy(bl)
    w_qkv, b_qkv = tfm.pack_qkv(*map(torch.from_numpy, w))
    qkv = tfm.qkv_gemm_plain(tfm.ln_rows_plain(xt, g, bl, 1e-5), w_qkv, b_qkv)
    want = tfm.ln_qkv_plain(xt, g, bl, w_qkv, b_qkv, 1e-5)
    assert torch.equal(qkv, torch.cat(want, dim=-1))


# --- (b), (c) the plain versions against the JAX kernels at large-v3's width ----


def test_k3c_plain_matches_jax_chunked_kernel():
    """d=1280, mlp 5120, erf: JAX's fused_ln_mlp_residual routes this width
    to the hidden-chunk split (_ln_mlp_csplit_kernel, interpret mode on the
    CPU); the port's plain version (which the launches' plain versions
    compose to, bit for bit) within 2 ulps of it."""
    d, mlp = 1280, 5120
    assert not jfm.mlp_fits_vmem(d, mlp) and jfm.mlp_csplit_fits_vmem(d, mlp)
    x, params = _mlp_inputs(40, d, mlp, seed=80)
    want = jfm.fused_ln_mlp_residual(jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, params),
                                     1e-5, "erf")
    xt = torch.from_numpy(x).to(torch.bfloat16)
    g, bl, w1, b1, w2, b2 = map(torch.from_numpy, params)
    got = tfm.ln_mlp_residual_plain(xt, g, bl, w1, b1, w2, b2, 1e-5, "erf")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, 40, d)
    assert bf16_ulps(got.float().numpy(), np.asarray(want, np.float32)) <= ULP_BAR
    assert torch.equal(tfm.fused_ln_mlp_residual(xt, g, bl, w1, b1, w2, b2, 1e-5, "erf"), got)


def test_k5_plain_matches_jax_kernel_at_large_v3_width(monkeypatch):
    """d=1280: JAX's fused_ln_qkv would take its XLA reference here (the
    resident weights exceed its VMEM budget), so the kernel
    (_ln_qkv_kernel, interpret mode) is reached as the JAX package's own
    tests reach a route, with the fit check patched."""
    d = 1280
    x, params = _qkv_inputs(40, d, seed=81)
    monkeypatch.setattr(jfm, "qkv_fits_vmem", lambda d_, out: True)
    want = jfm._fused_ln_qkv_fwd_impl.__wrapped__(jnp.asarray(x, jnp.bfloat16),
                                                  *map(jnp.asarray, params), 1e-5)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    g, bl, *w = map(torch.from_numpy, params)
    w_qkv, b_qkv = tfm.pack_qkv(*w)
    got = tfm.fused_ln_qkv(xt, g, bl, w_qkv, b_qkv, 1e-5)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16 and tuple(a.shape) == (1, 40, d)
        assert bf16_ulps(a.float().numpy(), np.asarray(b, np.float32)) <= ULP_BAR, name


# --- (d) the wrappers' shape rules and launches, on meta tensors ----------------


def _meta(*shape):
    return torch.empty(*shape, device="meta", dtype=torch.bfloat16)


@pytest.fixture
def launches(monkeypatch):
    """The wrappers with the device check passed and launch recorded: meta
    tensors stand in for CUDA ones, and nothing is built or run."""
    calls = []
    for mod in (tfm, tfa):
        monkeypatch.setattr(mod, "check_cuda", lambda *a: None)
        monkeypatch.setattr(mod, "launch", lambda name, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("d,N", [(96, 384), (128, 192), (2112, 384)],
                         ids=["d%64", "N%128", "d>2048"])
def test_qkv_wrapper_refuses_shapes_the_kernels_do_not_take(launches, d, N):
    with pytest.raises(ValueError, match="unsupported shape"):
        tfm.fused_ln_qkv(_meta(1, 8, d), torch.ones(d), torch.zeros(d), _meta(d, N), _meta(N))
    assert not launches


@pytest.mark.parametrize("d,mlp", [(96, 256), (128, 192), (192, 256)],
                         ids=["d%64", "fc1-N%128", "fc2-N%128"])
def test_mlp_wrapper_refuses_shapes_the_kernels_do_not_take(launches, d, mlp):
    with pytest.raises(ValueError, match="unsupported shape"):
        tfm.fused_ln_mlp_residual(_meta(1, 8, d), torch.ones(d), torch.zeros(d),
                                  _meta(d, mlp), _meta(mlp), _meta(mlp, d), _meta(d))
    assert not launches


def test_wrappers_launch_with_the_c_signatures(launches):
    """One launch a wrapper call with the argument count of the C entry
    point (the stream is added by launch), the row count B*T, and the
    counters counting wrapper calls: K5, K3 at d=512, K3c at d=1280; and
    K2's three C calls (four kernels): the LN + q/k/v path, the attention
    core on the packed q/k/v, the out-projection with K2's epilogue."""
    for c in (tfm.QKV_COUNTER, tfm.COUNTER, tfm.K3C_COUNTER):
        c.reset()
    q, k, v = tfm.fused_ln_qkv(_meta(2, 40, 1280), torch.ones(1280), torch.zeros(1280),
                               _meta(1280, 3840), _meta(3840))
    assert tuple(q.shape) == tuple(k.shape) == tuple(v.shape) == (2, 40, 1280)
    for d, mlp, form in ((512, 2048, "tanh"), (1280, 5120, "erf")):
        out = tfm.fused_ln_mlp_residual(_meta(2, 40, d), torch.ones(d), torch.zeros(d),
                                        _meta(d, mlp), _meta(mlp), _meta(mlp, d), _meta(d),
                                        1e-5, form)
        assert tuple(out.shape) == (2, 40, d)
    names = [name for name, _ in launches]
    assert names == ["jl_ln_qkv", "jl_ln_mlp_residual", "jl_ln_mlp_residual"]
    for name, args in launches:
        assert len(args) + 1 == len(_build.SIGNATURES[name])
    assert launches[0][1][-4:-1] == (80, 1280, 3840)
    assert launches[1][1][-5:-1] == (80, 512, 2048, 0)
    assert launches[2][1][-5:-1] == (80, 1280, 5120, 1)
    assert (tfm.QKV_COUNTER.launches, tfm.COUNTER.launches, tfm.K3C_COUNTER.launches) == (1, 1, 1)
    d = 512
    w = torch.zeros(d, d)
    tfa.fused_attention_sublayer(_meta(1, 8, d), torch.ones(d), torch.zeros(d), w, w[0], w, w,
                                 w[0], w, w[0], torch.ones(1, dtype=torch.int32), 4)
    assert [name for name, _ in launches[3:]] == [
        "jl_ln_qkv", "jl_attention_core", "jl_attn_out_proj"]
    for name, args in launches[3:]:
        assert len(args) + 1 == len(_build.SIGNATURES[name])
    assert launches[3][1][-4:-1] == (8, d, 3 * d)
    assert launches[4][1][-5:] == (1, 8, 4, 128, tfa.attention_scale(128))
    assert launches[5][1][-2:] == (8, d)


def test_serving_weights_reach_the_kernels_uncopied():
    """The wrappers' operand cast, .to(device, bf16).contiguous(), is the
    tensor itself for serving's bf16 copies (layers.cast_for_serving), so a
    serving call copies no weight."""
    dense = layers.Dense(64, 128, torch.Generator().manual_seed(0))
    dense.cast_for_serving(torch.bfloat16)
    with torch.no_grad():
        kernel, bias = dense.weights(torch.bfloat16)
        for t in (kernel, bias):
            assert t.to(t.device, torch.bfloat16).contiguous() is t



def test_bf16_ctc_bundle_serves_k2_and_k3_its_kept_copies(monkeypatch):
    """ModelBundle.load of a bf16 CTC bundle casts the whole model for
    serving: K2's route hands the wrapper the kept packed q/k/v operands and
    the out-projection's bf16 copies, K3's the fc1 / fc2 copies, the same
    tensors on every call, each its own .to(bf16).contiguous() (so the
    wrappers copy no weight); the WF path would read the f32 kernels."""
    from jiao_liao_speech_recognition_torch.models.bundle import ModelBundle
    from jiao_liao_speech_recognition_torch.utils.config import CTCModelConfig, ExperimentConfig

    cfg = ExperimentConfig(ctc_model=CTCModelConfig(
        vocab_size=40, d_model=128, num_layers=1, num_heads=2, mlp_dim=256, conv_channels=32))
    blk = ModelBundle.load(config=cfg, device="cpu").model.blocks[0]
    seen = []
    monkeypatch.setattr(layers, "fused_attention_sublayer_packed",
                        lambda x, g, bl, *w: seen.append(w[:4]) or x)
    monkeypatch.setattr(layers, "fused_ln_mlp_residual",
                        lambda x, g, bl, *w: seen.append(w[:4]) or x)
    x = torch.zeros(1, 8, 128, dtype=torch.bfloat16)
    lens = torch.full((1,), 8, dtype=torch.int32)
    with torch.inference_mode():
        for _ in range(2):
            blk._serve_attention(x, lens, kernels=True)
            blk._serve_mlp(x, kernels=True)
        sa, mlp = blk.self_attn, blk.mlp
        kept = [(*sa.qkv_weights(torch.bfloat16), *sa.out_proj.weights(torch.bfloat16)),
                (*mlp.fc1.weights(torch.bfloat16), *mlp.fc2.weights(torch.bfloat16))]
    assert len(seen) == 4
    for got, want in zip(seen, kept * 2):
        for g, w in zip(got, want):
            assert g is w and g.dtype == torch.bfloat16
            assert g.to(g.device, torch.bfloat16).contiguous() is g
    assert sa.q_proj.kernel.dtype == mlp.fc1.kernel.dtype == torch.float32


# --- (e) the persistent GEMM's schedule and the cheap GELU --------------------


def _ln_gemm_source():
    return (Path(tfm.__file__).parents[1] / "csrc" / "ln_gemm.cu").read_text()


def _gemm_schedule(M, N, sms=132):
    """Twin of csrc/ln_gemm.cu's static schedule: grid min(tiles, sms); block
    b walks tiles b, b + grid, ...; its j-th tile goes to consumer
    warpgroup j % 2; tile t is rows (t // n_tiles) * 128 and columns
    (t % n_tiles) * 128. -> {block: [(warpgroup, m0, n0), ...]}, grid."""
    n_tiles, tiles = N // 128, (N // 128) * -(-M // 128)
    grid = min(tiles, sms)
    walk = {b: [(j % 2, (t // n_tiles) * 128, (t % n_tiles) * 128)
                for j, t in enumerate(range(b, tiles, grid))] for b in range(grid)}
    return walk, grid


@pytest.mark.parametrize("M", [1, 37, 24000])
@pytest.mark.parametrize("N", [128, 512, 1536, 2048])
def test_persistent_schedule_visits_every_tile_once(M, N):
    """Every output tile once, the warpgroups of a block alternating, and
    the turn barriers balanced: warpgroup w waits before each of its tiles
    but the block's first, and is let go after each tile of the other's
    that has a successor, so no arrival is left over."""
    walk, grid = _gemm_schedule(M, N)
    visited = [(m0, n0) for tiles in walk.values() for _, m0, n0 in tiles]
    want = {(m, n) for m in range(0, -(-M // 128) * 128, 128) for n in range(0, N, 128)}
    assert len(visited) == len(want) == len(set(visited)) and set(visited) == want
    assert grid == min(len(want), 132) and all(walk[b] for b in walk)
    for tiles in walk.values():
        assert [w for w, _, _ in tiles] == [j % 2 for j in range(len(tiles))]
        for w in (0, 1):
            waits = sum(1 for j, (ww, _, _) in enumerate(tiles) if ww == w and j > 0)
            lets = sum(1 for j in range(len(tiles) - 1) if tiles[j + 1][0] == w)
            assert waits == lets
    # the rows of tiles in flight at once: the blocks sweep whole rows
    if M == 24000 and N == 2048:
        first = sorted(walk[b][0][1] for b in walk)
        assert first[-1] - first[0] == 128 * ((132 - 1) // 16)


def _consts(name):
    """csrc/<name>'s integer constants (expressions of literals evaluated)."""
    src = (Path(tfm.__file__).parents[1] / "csrc" / name).read_text()
    return {n: eval(v, {}) for n, v in  # noqa: S307 - digits and + - only
            re.findall(r"constexpr (?:int|uint32_t) (k\w+) = ([0-9 +\-*]+);", src)}


def test_persistent_gemm_shared_memory_fits_one_block_an_sm():
    """The stages (32 KB each), the two warpgroups' 32 KB staging tiles, fc1's
    GELU table and the barriers, from a 1024-aligned base, within the 227 KB
    a block may take (csrc/ln_gemm.cu's GemmLayout), for the GELU instances
    and the others."""
    gemm, common = _consts("ln_gemm.cu"), _consts("common.cuh")
    table = 2 * (common["kGeluE1"] - common["kGeluE0"]) * 128 * 2
    for stages, extra in ((gemm["kDefaultStages"], 0), (gemm["kGeluStages"], table)):
        smem = 1024 + stages * 32768 + 2 * 32768 + extra + (2 * stages + 3) * 8
        assert 3 <= stages and smem <= _build.SMEM_LIMIT


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("form", ["tanh", "erf"])
def test_gelu_table_gives_gelu_f32_bits_on_every_bf16_input(form):
    """csrc/common.cuh's gelu_lookup emulated over all 65,536 bf16 inputs:
    the table (the form's own bf16 result for 2^-24 <= |h| < 16) and the
    rules outside it (bf16(0.5 h) below, h or -0 above, +inf, NaN) give
    gelu_f32's bits for every input, with torch's tanh and exp here (the
    card's tanhf and expf are checked the same way by chip_smoke.py)."""
    k = _consts("common.cuh")
    bits = np.arange(65536, dtype=np.uint32)
    h = (bits << 16).view(np.float32)
    ref = _bf16(tfm.gelu_f32(torch.from_numpy(h), form).numpy()).view(torch.int16).numpy()
    sign, e, m = bits >> 15, (bits >> 7) & 0xFF, bits & 0x7F
    inside = (e >= k["kGeluE0"]) & (e < k["kGeluE1"])
    got = np.where(inside, ref, 0).astype(np.int16)  # the table: the form's bits
    tiny = _bf16(h * np.float32(0.5)).view(torch.int16).numpy()
    big = np.where((sign == 0) & ((e != 0xFF) | (m == 0)), bits,
                   np.where(e == 0xFF, 0x7FFF, 0x8000)).astype(np.uint16).view(np.int16)
    got = np.where(inside, got, np.where(e < k["kGeluE0"], tiny, big))
    nan = np.isnan(tfm.gelu_f32(torch.from_numpy(h), form).numpy())
    assert np.array_equal(got[~nan], ref[~nan])
    assert np.all(got[nan] == 0x7FFF)  # every NaN result the canonical one
