"""The port's A/B probes (ops/probes.py: P4 W8A8 LN+MLP+residual, P1 bf16x3
log-mel, P2 chunked head+argmax) against the JAX probe kernels themselves.

The probe kernels are closures inside each example script's main(), so a
test runs main() with small arguments under a patched
``jax.experimental.pallas.pallas_call``: the JAX package's own kernels pass
through, and the probe kernel's call is recorded and stops main(). The
test then runs the real pallas_call (interpret mode on the CPU) on its own
seeded numpy inputs of the captured shapes and holds the port's plain
version against it. Also: the wrappers take the plain version on CPU
tensors and raise on shapes their kernels do not take, nothing but the
profilers calls them, and the port's profilers exit non-zero without a
CUDA device."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from jiao_liao_speech_recognition_tpu.frontend import features as jf  # noqa: E402
from jiao_liao_speech_recognition_tpu.frontend.pallas_frontend import FRAME_TILE  # noqa: E402
from jiao_liao_speech_recognition_tpu.ops import quant as jq  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend.features import normalize_log_mel  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend.fused_frontend import log_mel_raw_plain  # noqa: E402
from jiao_liao_speech_recognition_torch.ops import fused_head, fused_mlp, probes  # noqa: E402
from jiao_liao_speech_recognition_torch.ops.quant import quantize_int8  # noqa: E402
from jiao_liao_speech_recognition_torch.utils.config import FrontendConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "jiao_liao_speech_recognition_torch"
# P4: bf16 outputs that round at the same points; the int8 codes agree, and
# the f32 sums (LN statistics, the epilogues) differ only in order
ULP_BAR = 2.0
# P1: the JAX package's log-mel parity bar, on the Whisper-normalized
# surface; products of bf16 values are exact, only f32 sums are reordered
LOGMEL_BAR = 2e-4
# P2: ids compared where the top-2 logit margin clears ARGMAX_MARGIN, on at
# least MIN_COVERAGE of the frames (the f32 logits differ by summation order)
ARGMAX_MARGIN = 1e-3
MIN_COVERAGE = 0.9
N_FFT, HOP, MELS = 400, 160, 80


class _Captured(Exception):
    """Stops a probe's main() at its kernel's pallas_call."""


def _capture(monkeypatch, script, argv, name):
    """Run examples/<script>.main() until it calls pallas_call with the
    kernel `name` -> a function of the kernel's inputs that runs it, with
    the captured grid and specs, through the real pallas_call."""
    real = pl.pallas_call
    seen = {}

    def spy(kernel, *args, **kwargs):
        if getattr(kernel, "func", kernel).__name__ == name:
            seen["kernel"], seen["kwargs"] = kernel, kwargs
            raise _Captured
        return real(kernel, *args, **kwargs)

    update = jax.config.update

    def keep_cache_settings(key, value):  # the scripts point the XLA cache elsewhere
        if not key.startswith(("jax_compilation_cache", "jax_persistent_cache")):
            update(key, value)

    monkeypatch.setattr(pl, "pallas_call", spy)
    monkeypatch.setattr(jax.config, "update", keep_cache_settings)
    monkeypatch.setattr(sys, "argv", [f"{script}.py", *argv])
    spec = importlib.util.spec_from_file_location(script, ROOT / "examples" / f"{script}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(_Captured):
        mod.main()
    return lambda *inputs: np.asarray(real(seen["kernel"], **seen["kwargs"])(*inputs))


def _ulps(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7))


def _t(a):
    return torch.from_numpy(np.array(a))


# --- P4 ------------------------------------------------------------------------


def _w8a8_inputs(zero_row=False, d=512, mlp=2048):
    rng = np.random.RandomState(3)
    x = (0.5 * rng.randn(1, 256, d)).astype(np.float32)
    g = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    bl = (0.05 * rng.randn(d)).astype(np.float32)
    w1 = (rng.randn(d, mlp) / np.sqrt(d)).astype(np.float32)
    b1 = (0.02 * rng.randn(mlp)).astype(np.float32)
    w2 = (rng.randn(mlp, d) / np.sqrt(mlp)).astype(np.float32)
    b2 = (0.02 * rng.randn(d)).astype(np.float32)
    if zero_row:  # a constant row with zero LN bias and b1: both row scales are 0
        x[0, 5] = 0.25
        bl[:] = 0.0
        b1[:] = 0.0
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # bf16 values
    return x, g, bl, w1, b1, w2, b2


@pytest.mark.parametrize("zero_row", [False, True])
def test_w8a8_plain_matches_the_probe_kernel(monkeypatch, zero_row):
    run = _capture(monkeypatch, "profile_w8a8_mlp", ["--b", "1", "--t", "8"], "w8a8_kernel")
    x, g, bl, w1, b1, w2, b2 = _w8a8_inputs(zero_row)
    (w1q, s1), (w2q, s2) = jq.quantize_int8(jnp.asarray(w1)), jq.quantize_int8(jnp.asarray(w2))
    want = run(jnp.asarray(x, jnp.bfloat16), g[None], bl[None], w1q, s1[None], b1[None], w2q,
               s2[None], b2[None]).astype(np.float32)
    got = probes.w8a8_ln_mlp_residual_plain(
        _t(x).to(torch.bfloat16), _t(g), _t(bl), _t(w1q), _t(s1), _t(b1), _t(w2q), _t(s2),
        _t(b2), 1e-5, "tanh").float().numpy()
    assert got.shape == want.shape == (1, 256, 512)
    assert _ulps(got, want) <= ULP_BAR
    if zero_row:  # safe scales of 1, zero codes: the row is x + bf16(b2)
        row = (torch.tensor(0.25, dtype=torch.bfloat16) + _t(b2).to(torch.bfloat16)).float()
        np.testing.assert_array_equal(want[0, 5], row.numpy())
        np.testing.assert_array_equal(got[0, 5], row.numpy())


def _w8a8_operands(zero_row=False, rows=200, d=512, mlp=2048):
    x, g, bl, w1, b1, w2, b2 = _w8a8_inputs(zero_row, d, mlp)
    (w1q, s1), (w2q, s2) = quantize_int8(_t(w1)), quantize_int8(_t(w2))
    raw = (w1q, s1, _t(b1), w2q, s2, _t(b2))
    return _t(x[:, :rows]).to(torch.bfloat16), _t(g), _t(bl), raw


@pytest.mark.parametrize("gelu_form", ["tanh", "erf"])
@pytest.mark.parametrize("zero_row", [False, True])
def test_w8a8_prepared_operands_give_the_plain_bits(zero_row, gelu_form):
    """The weights as w8a8_operands lays them out for the kernel (codes
    K-major, f32 scales and biases), through the wrapper on CPU tensors,
    give the plain version's bits on the raw operands."""
    x, g, bl, raw = _w8a8_operands(zero_row)
    ops = probes.w8a8_operands(*raw)
    assert tuple(ops.w1t.shape) == (2048, 512) and tuple(ops.w2t.shape) == (512, 2048)
    assert ops.w1t.is_contiguous() and ops.w2t.is_contiguous()
    got = probes.w8a8_ln_mlp_residual(x, g, bl, ops, 1e-5, gelu_form)
    assert torch.equal(got, probes.w8a8_ln_mlp_residual_plain(x, g, bl, *raw, 1e-5, gelu_form))


def _bits_max(values: torch.Tensor) -> torch.Tensor:
    """csrc/w8a8_mlp.cu's merge of non-negative f32 values: an integer max
    on their bits (atomicMax on the int32 view), read back as f32."""
    return values.view(torch.int32).max().view(1).view(torch.float32)[0]


def _w8a8_twin(x, g, bl, ops, eps, gelu_form, tile_order):
    """csrc/w8a8_mlp.cu's schedule on the CPU: LN codes and scales per row
    (the plain version's ops); fc1 on 128 x 128 tiles (rows padded with
    zero codes to whole tiles, as TMA reads them), each tile's row amax of
    |GELU(h)| merged into the row's amax by an integer max on the bits, in
    ``tile_order``; fc1 again on every tile,
    the codes with h_s = amax / 127; fc2 and the residual. -> out, as the
    four launches give it."""
    B, T, d = x.shape
    M, mlp = B * T, ops.w1t.shape[0]
    xf = x.reshape(M, d).float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    ln = (xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)) * g + bl
    lq, a_s = probes._quantize_rows(ln)
    Mp = -(-M // 128) * 128
    lq = torch.cat([lq, lq.new_zeros(Mp - M, d)])
    a_s = torch.cat([a_s, a_s.new_zeros(Mp - M, 1)])
    tiles = [(m0, n0) for m0 in range(0, Mp, 128) for n0 in range(0, mlp, 128)]

    def h_tile(m0, n0):
        acc = probes._int_product(lq[m0:m0 + 128], ops.w1t[n0:n0 + 128].t())
        return acc * (a_s[m0:m0 + 128] * ops.s1[n0:n0 + 128]) + ops.b1[n0:n0 + 128]

    amax = torch.zeros(Mp)  # set by the LN launch
    for i in tile_order(len(tiles)):  # the atomicMax launch, in any order
        m0, n0 = tiles[i]
        tile_max = fused_mlp.gelu_f32(h_tile(m0, n0), gelu_form).abs().amax(-1)
        for r in range(128):
            amax[m0 + r] = _bits_max(torch.stack([amax[m0 + r], tile_max[r]]))
    h_s = amax[:, None] / 127.0
    safe = torch.where(h_s > 0, h_s, torch.ones_like(h_s))
    hq = torch.zeros(Mp, mlp)
    for m0, n0 in tiles:  # the codes launch: fc1 again, the same bits
        hq[m0:m0 + 128, n0:n0 + 128] = torch.clamp(torch.round(
            fused_mlp.gelu_f32(h_tile(m0, n0), gelu_form) / safe[m0:m0 + 128]), -127, 127)
    y = probes._int_product(hq[:M], ops.w2t.t()) * (h_s[:M] * ops.s2) + ops.b2
    return (x.reshape(M, d) + y.to(x.dtype)).view(B, T, d)


@pytest.mark.parametrize("gelu_form", ["tanh", "erf"])
@pytest.mark.parametrize("zero_row", [False, True])
def test_w8a8_kernel_schedule_twin_gives_the_plain_bits(zero_row, gelu_form):
    """The twin of P4's four launches (_w8a8_twin) at 200 rows (a ragged
    second row tile), with a zero row whose scales are 0, merging the
    tiles' amax in a shuffled order: bit for bit the plain version."""
    x, g, bl, raw = _w8a8_operands(zero_row)
    ops = probes.w8a8_operands(*raw)
    want = probes.w8a8_ln_mlp_residual_plain(x, g, bl, *raw, 1e-5, gelu_form)
    shuffled = lambda n: np.random.RandomState(7).permutation(n)  # noqa: E731
    assert torch.equal(_w8a8_twin(x, g, bl, ops, 1e-5, gelu_form, shuffled), want)


@pytest.mark.parametrize("d, mlp, gelu_form", [(1024, 256, "erf"), (2048, 128, "tanh")])
def test_w8a8_other_widths_give_the_plain_bits(d, mlp, gelu_form):
    """Widths the wrapper takes besides the flagship's, d > mlp among them
    (the card runs such cases beside the flagship's): the prepared operands
    through the wrapper on CPU tensors, and the twin of the four launches
    at 200 rows, give the plain version's bits."""
    x, g, bl, raw = _w8a8_operands(d=d, mlp=mlp)
    ops = probes.w8a8_operands(*raw)
    assert tuple(ops.w1t.shape) == (mlp, d) and tuple(ops.w2t.shape) == (d, mlp)
    want = probes.w8a8_ln_mlp_residual_plain(x, g, bl, *raw, 1e-5, gelu_form)
    assert torch.equal(probes.w8a8_ln_mlp_residual(x, g, bl, ops, 1e-5, gelu_form), want)
    shuffled = lambda n: np.random.RandomState(7).permutation(n)  # noqa: E731
    assert torch.equal(_w8a8_twin(x, g, bl, ops, 1e-5, gelu_form, shuffled), want)


def _merge_in_order(values: torch.Tensor, order) -> torch.Tensor:
    """The bits-merge of ``values`` taken in ``order``, from 0 (the LN
    launch's reset of a hidden row's amax)."""
    merged = torch.zeros(())
    for i in order:
        merged = _bits_max(torch.stack([merged, values[i]]))
    return merged


@pytest.mark.parametrize("seed", range(6))
def test_amax_merge_on_float_bits_is_order_free_seeded(seed):
    """Non-negative f32 values (zero, subnormals, the smallest normal, the
    largest finite, inf, and values of every scale) order as their int32
    bits do: an integer max over the bits, in any order of merges from 0,
    is the float max (the kernel's atomicMax on the hidden rows' amax)."""
    rng = np.random.RandomState(seed)
    fi = np.finfo(np.float32)
    special = np.array([0.0, fi.smallest_subnormal, 1e-40, fi.tiny, fi.max, np.inf], np.float32)
    scaled = (rng.rand(34) * 10.0 ** rng.randint(-45, 38, 34)).astype(np.float32)
    n_special = rng.randint(0, 4)  # a row without inf or zero too
    values = torch.from_numpy(np.concatenate([rng.choice(special, n_special), scaled]))
    want = values.max()
    for _ in range(5):
        got = _merge_in_order(values, rng.permutation(len(values)))
        assert got.view(torch.int32) == want.view(torch.int32)


def test_amax_merge_on_float_bits_is_order_free():
    """The seeded test's property over lists and orders that hypothesis
    draws (derandomized, so every run draws the same)."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies
    floats = st.floats(min_value=0.0, allow_nan=False, allow_infinity=True, width=32)

    @hypothesis.settings(max_examples=200, deadline=None, derandomize=True, database=None)
    @hypothesis.given(st.lists(floats, min_size=1, max_size=40), st.randoms(use_true_random=False))
    def order_free(values, rnd):
        order = list(range(len(values)))
        rnd.shuffle(order)
        t = torch.tensor(values, dtype=torch.float32)
        assert _merge_in_order(t, order).view(torch.int32) == t.max().view(torch.int32)

    order_free()


def _cu_consts(name):
    """The integer constexpr constants of csrc/<name>."""
    import re

    src = (PKG / "csrc" / name).read_text()
    return {k: eval(v, {}) for k, v in  # noqa: S307 - digits and + - * only
            re.findall(r"constexpr (?:int|uint32_t) (k\w+) = ([0-9 +\-*]+);", src)}


def test_w8a8_gemm_fits_an_sm_and_its_register_budgets():
    """csrc/w8a8_mlp.cu's GEMM: the stages (an A and a B box of 128 x 128
    int8 each), kQuant's four 64-row staged code tiles and the barriers,
    from a 1024-aligned base, within the 227 KB one block may take; and
    setmaxnreg's budgets: the consumers take only what the producer
    warpgroup gives up of the block's entry count (65,536 registers over
    its threads, rounded down to 8)."""
    from jiao_liao_speech_recognition_torch import _build

    k = _cu_consts("w8a8_mlp.cu")
    threads = (k["kConsumerWGs"] + 1) * 128  # kGemmThreads
    box = k["kBM"] * k["kBK"]  # kBoxBytes
    smem = (1024 + k["kStages"] * 2 * box + k["kConsumerWGs"] * 64 * k["kBN"]
            + (2 * k["kStages"] + 1) * 8)
    assert k["kStages"] >= 3 and smem <= _build.SMEM_LIMIT
    entry = 65536 // threads // 8 * 8
    consumer, producer = k["kConsumerRegs"], k["kProducerRegs"]
    assert 0 <= (consumer - entry) * 128 * k["kConsumerWGs"] <= (entry - producer) * 128
    assert consumer % 8 == 0 and producer % 8 == 0 and producer >= 24


# --- P1 ------------------------------------------------------------------------


def _wav(secs=1.0):
    rng = np.random.RandomState(4)
    t = np.arange(int(16000 * secs)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.randn(len(t))).astype(np.float32)[None]


def _probe_frontend_inputs(wav):
    """The probe wrapper's operands: the reflect-padded signal as k
    hop-shifted [B, t_pad, hop] frame views, the [k hop, 512] basis and the
    [256, 128] mel matrix (examples/profile_frontend_precision.py)."""
    B, L = wav.shape
    frames, k = L // HOP, -(-N_FFT // HOP)
    x = np.pad(wav, ((0, 0), (N_FFT // 2, N_FFT // 2)), mode="reflect")
    t_pad = max(-(-frames // FRAME_TILE) * FRAME_TILE, FRAME_TILE)
    need = (t_pad + k) * HOP
    x = np.pad(x, ((0, 0), (0, max(0, need - x.shape[1]))))[:, :need].reshape(B, t_pad + k, HOP)
    basis = np.zeros((k * HOP, 512), np.float32)
    basis[:N_FFT, :2 * (N_FFT // 2 + 1)] = jf._dft_basis(N_FFT).T
    mel = np.zeros((256, 128), np.float32)
    mel[:N_FFT // 2 + 1, :MELS] = jf.mel_filterbank(MELS, N_FFT).T
    return [x[:, j:j + t_pad] for j in range(k)] + [basis, mel], frames


def test_bf16x3_plain_matches_the_probe_kernel(monkeypatch):
    run = _capture(monkeypatch, "profile_frontend_precision",
                   ["--batch", "1", "--secs", "1", "--iters", "1"], "_kernel_split")
    wav = _wav()
    inputs, frames = _probe_frontend_inputs(wav)
    assert [a.shape for a in inputs] == [(1, 512, 160)] * 3 + [(480, 512), (256, 128)]
    want = torch.from_numpy(run(*inputs)[:, :frames, :MELS].transpose(0, 2, 1).copy())
    got = probes.log_mel_bf16x3_plain(_t(wav))
    assert got.shape == want.shape == (1, MELS, frames)
    fe = FrontendConfig()
    err = float((normalize_log_mel(got, fe) - normalize_log_mel(want, fe)).abs().max())
    assert err <= LOGMEL_BAR, err
    # the probe's finding, printed: the split against the full-f32 log-mel
    gap = (normalize_log_mel(got, fe) - normalize_log_mel(log_mel_raw_plain(_t(wav)), fe))
    print(f"bf16x3 against f32, Whisper-normalized: max {float(gap.abs().max()):.3e}")


# --- P2 ------------------------------------------------------------------------


def _head_inputs():
    rng = np.random.RandomState(5)
    x = np.asarray(jnp.asarray(0.3 * rng.randn(8, 128, 512), jnp.bfloat16).astype(jnp.float32))
    w = (0.05 * rng.randn(512, 4336)).astype(np.float32)
    b = (0.01 * rng.randn(4336)).astype(np.float32)
    return x, w, b


def _probe_head(run, x, w, b):
    """The probe wrapper's operands: W zero-padded and b padded with -1e30
    to whole 512-column chunks."""
    v_pad = -(-w.shape[1] // 512) * 512
    wp = jnp.asarray(np.pad(w, ((0, 0), (0, v_pad - w.shape[1]))), jnp.bfloat16)
    bp = np.pad(b, (0, v_pad - b.shape[0]), constant_values=-1e30)[None]
    return run(jnp.asarray(x, jnp.bfloat16), wp, bp)


def test_head_plain_matches_the_probe_kernel(monkeypatch):
    run = _capture(monkeypatch, "profile_head_kernel", ["--batch", "8", "--frames", "128"],
                   "_kernel_fori")
    x, w, b = _head_inputs()
    want = _probe_head(run, x, w, b)
    xt = _t(x).to(torch.bfloat16)
    got = fused_head.head_argmax_plain(xt, _t(w), _t(b)).numpy()
    top2 = fused_head.head_logits(xt, _t(w), _t(b)).topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]).numpy() > ARGMAX_MARGIN
    assert got.shape == want.shape == (8, 128)
    assert clear.mean() >= MIN_COVERAGE
    assert (got[clear] == want[clear]).all()
    # ties (exact: zero weight columns, equal biases) go to the first index,
    # across chunks (7, 4000) and inside one (130, 250)
    for first, second in ((7, 4000), (130, 250)):
        wt, bt = w.copy(), b.copy()
        wt[:, [first, second]] = 0.0
        bt[[first, second]] = 100.0
        assert (_probe_head(run, x, wt, bt) == first).all()
        for fn in (fused_head.head_argmax_plain, probes.head_argmax_chunked):
            assert (fn(xt, _t(wt), _t(bt)) == first).all()


# --- the wrappers ----------------------------------------------------------------


def _wrapper_cases():
    """key -> (wrapper, plain version, the wrapper's arguments, the plain
    version's, the launch counter)."""
    x, g, bl, raw = _w8a8_operands(rows=256)
    hx, hw, hb = _head_inputs()
    wav = (_t(_wav(0.5)),)
    head = (_t(hx[:2]).to(torch.bfloat16), _t(hw), _t(hb))
    return {
        "P4": (probes.w8a8_ln_mlp_residual, probes.w8a8_ln_mlp_residual_plain,
               (x, g, bl, probes.w8a8_operands(*raw), 1e-5, "tanh"),
               (x, g, bl, *raw, 1e-5, "tanh"), probes.W8A8_COUNTER),
        "P1": (probes.log_mel_bf16x3_raw, probes.log_mel_bf16x3_plain, wav, wav,
               probes.BF16X3_COUNTER),
        "P2": (probes.head_argmax_chunked, fused_head.head_argmax_plain, head, head,
               probes.CHUNKED_COUNTER),
    }


@pytest.mark.parametrize("key", ["P4", "P1", "P2"])
def test_wrapper_takes_the_plain_version_for_cpu_tensors(key):
    wrapper, plain, args, plain_args, counter = _wrapper_cases()[key]
    counter.reset()
    got = wrapper(*args)
    assert torch.equal(got, plain(*plain_args))
    assert torch.equal(wrapper(*args, kernels=False), got)
    assert counter.launches == 0


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _w8a8_call(d, mlp, gelu_form="tanh", fc2_in=None):
    i8 = torch.int8
    return lambda: probes.w8a8_ln_mlp_residual(
        _meta(1, 16, d, dtype=torch.bfloat16), _meta(d), _meta(d), probes.w8a8_operands(
            _meta(d, mlp, dtype=i8), _meta(mlp), _meta(mlp), _meta(fc2_in or mlp, d, dtype=i8),
            _meta(d), _meta(d)), 1e-5, gelu_form)


@pytest.mark.parametrize("call", [
    _w8a8_call(320, 1280),  # d not a multiple of 128
    _w8a8_call(512, 2048, fc2_in=1024),  # fc2 does not take fc1's width
    _w8a8_call(2176, 4352),  # d over the LN row pass's 2048
    _w8a8_call(512, 2048, "relu"),
    lambda: probes.log_mel_bf16x3_raw(_meta(2, 16000), hop=100),  # hop % 16
    lambda: probes.log_mel_bf16x3_raw(_meta(2, 16000), n_fft=512),  # 257 freqs > 208
    lambda: probes.log_mel_bf16x3_raw(_meta(2, 150)),  # too short to reflect-pad
    # d = 1024 is taken (k streams through the TMA ring); bf16 rows of 100
    # columns are not 16-byte multiples, which the tensor map of W needs
    lambda: probes.head_argmax_chunked(_meta(1, 8, 1024, dtype=torch.bfloat16),
                                       _meta(1024, 100, dtype=torch.bfloat16), _meta(100)),
    lambda: probes.head_argmax_chunked(_meta(1, 8, 500, dtype=torch.bfloat16),
                                       _meta(500, 100), _meta(100)),  # d % 16
], ids=["p4-width", "p4-fc2-shape", "p4-ln-width", "p4-gelu", "p1-hop", "p1-freqs", "p1-short",
        "p2-smem", "p2-width"])
def test_wrapper_raises_on_shapes_its_kernel_does_not_take(monkeypatch, call):
    with pytest.raises(ValueError, match="CUDA"):  # a device with no kernel
        call()
    for module in (probes, fused_head):  # P2 launches through K4's checks
        monkeypatch.setattr(module, "check_cuda", lambda *args: None)
    with pytest.raises(ValueError, match="unsupported|unknown"):
        call()


def test_no_port_module_calls_the_probes():
    importers = [f"{p.relative_to(ROOT)}:{i}" for p in sorted(PKG.rglob("*.py"))
                 for i, line in enumerate(p.read_text().splitlines(), 1)
                 if line.lstrip().startswith(("from ", "import ")) and "probes" in line]
    assert importers == []


@pytest.mark.parametrize("script", ["torch_profile_w8a8_mlp", "torch_profile_frontend_precision",
                                    "torch_profile_head_kernel"])
def test_profiler_exits_nonzero_without_cuda(script):
    r = subprocess.run([sys.executable, str(ROOT / "examples" / f"{script}.py")],
                       capture_output=True, text=True, timeout=300, cwd=ROOT,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert "needs a CUDA device" in r.stderr
    assert "{" not in r.stdout
