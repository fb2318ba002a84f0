"""K3: the fused LN + MLP + residual sublayer y = x + fc2(GELU(fc1(LN(x)))),
and K5: the fused LN + q/k/v projections.

Both run on ``csrc/ln_gemm.cu`` (the design note is there): an f32
LayerNorm pass into a bf16 scratch, then TMA + wgmma GEMMs with the bias,
GELU and residual folded into their epilogues. ``fused_ln_mlp_residual``
(three launches: ln_rows, fc1 + GELU into a hidden scratch, fc2 + residual)
replaces the JAX package's ``ops/fused_mlp.py::fused_ln_mlp_residual`` and,
at d=1280, its hidden-chunk split K3c; ``fused_ln_qkv`` (two launches:
ln_rows, then the [Wq | Wk | Wv] product + bias) replaces its
``fused_ln_qkv``. ``ln_mlp_residual_plain`` and ``ln_qkv_plain`` are the
same functions in plain PyTorch with the kernels' rounding points;
``ln_rows_plain``, ``qkv_gemm_plain``, ``fc1_gelu_plain`` and
``fc2_residual_plain`` are the plain version of each launch. Every rounding
point is a bf16 tensor, so the launches compose to the sublayer bit for
bit. The wrappers take the plain versions only for CPU tensors.

Under tensor parallelism K3 splits at fc2, the row-parallel product:
``ln_fc1`` (K3's first two launches alone, on a rank's mlp / tp columns;
``ln_fc1_plain``), then ``fused_attention.row_partial`` on the rank's rows
of fc2, whose f32 partials the ranks sum before b2 and x are added once.
K5 on a rank's heads may have a packed width that is not a multiple of
128 (3 x 320 at large-v3 on four ranks): ``pack_qkv(pad_to=128)`` pads the
operand with zero columns that no head reads, and ``fused_ln_qkv`` takes
the width of each projection.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import LaunchCounter, check_aligned, check_cuda, launch, refuse_grad
from .numerics import dense, layer_norm

COUNTER = LaunchCounter("fused_ln_mlp_residual")
# the d=1280 instance (the TPU's chunked K3c) counts its launches apart
K3C_COUNTER = LaunchCounter("fused_ln_mlp_residual_d1280")
LN_MAX_WIDTH = 2048  # ln_rows holds a row in registers (csrc/ln_gemm.cu)


def check_gemm_shapes(what: str, d: int, *products) -> None:
    """Raise ValueError unless csrc/ln_gemm.cu takes these shapes: the LN
    width d % 64 == 0 and d <= LN_MAX_WIDTH, and each product (K, N) with
    K % 64 == 0 (whole 64-deep TMA boxes of 128-byte rows) and N % 128 == 0
    (whole 128-column output tiles)."""
    if d % 64 or d > LN_MAX_WIDTH or any(k % 64 or n % 128 for k, n in products):
        raise ValueError(f"{what}: unsupported shape d={d}, products (K, N) {list(products)} "
                         f"(need d % 64 == 0, d <= {LN_MAX_WIDTH}, K % 64 == 0, N % 128 == 0)")


def gelu_f32(h: torch.Tensor, gelu_form: str) -> torch.Tensor:
    """GELU of an f32 tensor. 'tanh': jax.nn.gelu(approximate=True)'s op
    order; 'erf': the Abramowitz-Stegun 7.1.26 rational of the JAX kernel
    (|err| <= 1.5e-7), not torch's erf, so both paths share one formula."""
    if gelu_form == "tanh":
        c = float(np.float32(np.sqrt(2.0 / np.pi)))
        return h * (0.5 * (1.0 + torch.tanh(c * (h + 0.044715 * (h * h * h)))))
    if gelu_form == "erf":
        x = h * float(np.float32(1.0 / np.sqrt(2.0)))
        ax = x.abs()
        t = 1.0 / (1.0 + 0.3275911 * ax)
        poly = t * (0.254829592 + t * (-0.284496736 + t * (
            1.421413741 + t * (-1.453152027 + t * 1.061405429))))
        erf = torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))
        return 0.5 * h * (1.0 + erf)
    raise ValueError(f"unknown gelu_form {gelu_form!r} (want 'tanh'|'erf')")


# jl_gemm's epilogues: the GEMM instance each launch of K5, K3 and K2 runs
GEMM_EPILOGUES = {"qkv": 0, "fc1_tanh": 1, "fc1_erf": 2, "fc2": 3, "out_proj": 4}


def gemm_launch(epilogue: str, a, w, bias, res=None):
    """One launch of csrc/ln_gemm.cu's GEMM alone (jl_gemm), the instance a
    launch of K5, K3 or K2 runs (GEMM_EPILOGUES; res [M, N] for "fc2" and
    "out_proj"), on contiguous bf16 CUDA operands a [M, K], w [K, N], bias
    [N] -> [M, N]. For timing each launch apart (chip_smoke.py); counts
    nothing."""
    for name, t in (("a", a), ("w", w)):
        check_cuda(name, t, torch.bfloat16, 2)
    (M, K), N = a.shape, w.shape[1]
    check_gemm_shapes("gemm_launch", 64, (K, N))
    if (res is None) != (epilogue in ("qkv", "fc1_tanh", "fc1_erf")):
        raise ValueError(f"gemm_launch: {epilogue!r} takes a residual only for fc2 and out_proj")
    out = torch.empty(M, N, device=a.device, dtype=torch.bfloat16)
    check_aligned("gemm_launch", a, w, bias, out, *(() if res is None else (res,)))
    launch("jl_gemm", GEMM_EPILOGUES[epilogue], a.data_ptr(), w.data_ptr(), bias.data_ptr(),
           0 if res is None else res.data_ptr(), out.data_ptr(), M, N, K)
    return out


def gelu_check(values: torch.Tensor) -> torch.Tensor:
    """jl_gelu_check on bf16 CUDA values [n] -> [4, n] bf16: K3's GELUs as
    fc1's epilogue takes them (csrc/common.cuh's table lookup) and as the
    forms give them: lookup of gelu_tanh, gelu_tanh, lookup of gelu_erf,
    gelu_erf. chip_smoke.py runs it over every bf16 value."""
    check_cuda("values", values, torch.bfloat16, 1)
    out = torch.empty(4, values.numel(), device=values.device, dtype=torch.bfloat16)
    launch("jl_gelu_check", values.data_ptr(), out.data_ptr(), values.numel())
    return out


# --- the column-parallel half of a tensor-parallel MLP ------------------------

LN_FC1_COUNTER = LaunchCounter("ln_fc1")


def ln_fc1_plain(x, g, bl, w1, b1, eps=1e-5, gelu_form="tanh"):
    """jl_ln_fc1: K3's LN and fc1 + GELU, bf16(GELU(bf16(bf16(LN(x) . w1) +
    b1))), [..., mlp]."""
    return fc1_gelu_plain(ln_rows_plain(x, g, bl, eps), w1, b1, gelu_form)


def ln_fc1(x, g, bl, w1, b1, eps=1e-5, gelu_form="tanh"):
    """Wrapper of jl_ln_fc1 (csrc/ln_gemm.cu: ln_rows, then fc1's GEMM with
    the bias and GELU in its epilogue, K3's first two launches): a rank's
    hidden columns of a tensor-parallel MLP. CPU tensors take ln_fc1_plain;
    a CUDA tensor (x bf16 [B, T, d], w1 [d, mlp] with d % 64 == 0, d <=
    LN_MAX_WIDTH, mlp % 128 == 0) launches the kernels or raises."""
    if x.device.type == "cpu":
        return ln_fc1_plain(x, g, bl, w1, b1, eps, gelu_form)
    check_cuda("x", x, torch.bfloat16, 3)
    refuse_grad("ln_fc1", x, g, bl, w1, b1)
    B, T, d = x.shape
    mlp = w1.shape[1]
    if tuple(w1.shape) != (d, mlp) or tuple(b1.shape) != (mlp,):
        raise ValueError(f"fc1 weights {tuple(w1.shape)}, {tuple(b1.shape)} do not fit d={d}")
    check_gemm_shapes("ln_fc1", d, (d, mlp))
    if gelu_form not in ("tanh", "erf"):
        raise ValueError(f"unknown gelu_form {gelu_form!r} (want 'tanh'|'erf')")
    dev, bf = x.device, torch.bfloat16
    g32, bl32 = (t.to(dev, torch.float32).contiguous() for t in (g, bl))
    w1b, b1b = (t.to(dev, bf).contiguous() for t in (w1, b1))
    check_aligned("ln_fc1", x, g32, bl32, w1b, b1b)
    ln = torch.empty_like(x)
    h = torch.empty(B, T, mlp, device=dev, dtype=bf)
    launch("jl_ln_fc1", x.data_ptr(), g32.data_ptr(), bl32.data_ptr(), w1b.data_ptr(),
           b1b.data_ptr(), ln.data_ptr(), h.data_ptr(), B * T, d, mlp,
           int(gelu_form == "erf"), float(eps))
    LN_FC1_COUNTER.launches += 1
    return h


def ln_mlp_residual_plain(x, g, bl, w1, b1, w2, b2, eps=1e-5, gelu_form="tanh"):
    """x [B, T, d] (compute dtype); w1 [d, mlp], w2 [mlp, d]. GELU runs in
    f32 on the rounded fc1 output; y = x + (fc2 + b2)."""
    dt = x.dtype
    h = dense(layer_norm(x, g, bl, eps), w1, b1)
    h = gelu_f32(h.float(), gelu_form).to(dt)
    return x + dense(h, w2, b2)


# the plain version of each launch of csrc/ln_gemm.cu


def ln_rows_plain(x, g, bl, eps=1e-5):
    """ln_rows: LayerNorm with f32 statistics, rounded to x's dtype."""
    return layer_norm(x, g, bl, eps)


def qkv_gemm_plain(ln, w_qkv, b_qkv):
    """K5's product: bf16(bf16(ln . w_qkv) + b_qkv), [..., 3D]."""
    return dense(ln, w_qkv, b_qkv)


def fc1_gelu_plain(ln, w1, b1, gelu_form="tanh"):
    """K3's fc1: bf16(GELU_f32(bf16(bf16(ln . w1) + b1))), [..., mlp]."""
    return gelu_f32(dense(ln, w1, b1).float(), gelu_form).to(ln.dtype)


def fc2_residual_plain(x, h, w2, b2):
    """K3's fc2, and K2h-out's out-projection + residual after flash (the
    module path's order and the JAX block's long-context route), one launch
    of csrc/ln_gemm.cu: x + bf16(bf16(h . w2) + b2)."""
    return x + dense(h, w2, b2)


def fused_ln_mlp_residual(x, g, bl, w1, b1, w2, b2, eps=1e-5, gelu_form="tanh"):
    """K3 wrapper. CPU tensors take ln_mlp_residual_plain; a CUDA tensor
    (x bf16 [B, T, d]; d % 128 == 0, d <= LN_MAX_WIDTH, mlp % 128 == 0)
    launches jl_ln_mlp_residual (ln_rows, fc1 + GELU, fc2 + residual, with
    LN(x) and the hidden tensor in scratch allocated here) or raises."""
    if x.device.type == "cpu":
        return ln_mlp_residual_plain(x, g, bl, w1, b1, w2, b2, eps, gelu_form)
    check_cuda("x", x, torch.bfloat16, 3)
    refuse_grad("fused_ln_mlp_residual", x, g, bl, w1, b1, w2, b2)
    B, T, d = x.shape
    mlp = w1.shape[1]
    if tuple(w1.shape) != (d, mlp) or tuple(w2.shape) != (mlp, d):
        raise ValueError(f"MLP weights {tuple(w1.shape)}, {tuple(w2.shape)} do not fit d={d}")
    check_gemm_shapes("fused_ln_mlp_residual", d, (d, mlp), (mlp, d))
    if gelu_form not in ("tanh", "erf"):
        raise ValueError(f"unknown gelu_form {gelu_form!r} (want 'tanh'|'erf')")
    # .to(...).contiguous() returns serving's bf16 weight copies themselves,
    # so a serving call copies no weight
    dev, bf = x.device, torch.bfloat16
    g32, bl32 = (t.to(dev, torch.float32).contiguous() for t in (g, bl))
    w1b, b1b, w2b, b2b = (t.to(dev, bf).contiguous() for t in (w1, b1, w2, b2))
    check_aligned("fused_ln_mlp_residual", x, g32, bl32, w1b, b1b, w2b, b2b)
    ln = torch.empty_like(x)
    h = torch.empty(B, T, mlp, device=dev, dtype=bf)
    out = torch.empty_like(x)
    launch(
        "jl_ln_mlp_residual", x.data_ptr(), g32.data_ptr(), bl32.data_ptr(),
        w1b.data_ptr(), b1b.data_ptr(), w2b.data_ptr(), b2b.data_ptr(), ln.data_ptr(),
        h.data_ptr(), out.data_ptr(), B * T, d, mlp, int(gelu_form == "erf"), float(eps),
    )
    (K3C_COUNTER if d == 1280 else COUNTER).launches += 1
    return out


# --- K7 (MLP half): WF-adapted serving ---------------------------------------

WF_COUNTER = LaunchCounter("fused_ln_mlp_residual_wf")


def ln_mlp_residual_wf_plain(x, g, bl, w1, b1, w2, b2, wf1, wf2, eps, gelu_form, wf_scale):
    """The fold of both WF inserts (f32), then ln_mlp_residual_plain.
    wf1 / wf2 = {"a", "g", "b"} (the WFDense parameter layout)."""
    from .fused_attention import fold_wf

    return ln_mlp_residual_plain(
        x, g, bl, fold_wf(w1, wf1, wf_scale), b1, fold_wf(w2, wf2, wf_scale), b2,
        eps, gelu_form,
    )


def fused_ln_mlp_residual_wf(x, g, bl, w1, b1, w2, b2, wf1, wf2, eps, gelu_form, wf_scale):
    """K7 wrapper (MLP): the fold in f32, then the K3 wrapper. CPU tensors
    take ln_mlp_residual_wf_plain; CUDA tensors launch K3 or raise."""
    from .fused_attention import fold_wf

    if x.device.type == "cpu":
        return ln_mlp_residual_wf_plain(
            x, g, bl, w1, b1, w2, b2, wf1, wf2, eps, gelu_form, wf_scale
        )
    refuse_grad("fused_ln_mlp_residual_wf", x, w1, b1, w2, b2, *wf1.values(), *wf2.values())
    out = fused_ln_mlp_residual(
        x, g, bl, fold_wf(w1, wf1, wf_scale), b1, fold_wf(w2, wf2, wf_scale), b2,
        eps, gelu_form,
    )
    WF_COUNTER.launches += 1
    return out


# --- K5: LN + q/k/v projections ----------------------------------------------

QKV_COUNTER = LaunchCounter("fused_ln_qkv")


def pack_qkv(wq, bq, wk, wv, bv, dtype=torch.bfloat16, pad_to: int = 1):
    """-> ([d, N] kernel, [N] bias) in `dtype`: [Wq | Wk | Wv] and
    [bq | 0 | bv], the operands K5 takes (k has no bias), N = 3D rounded up
    to a multiple of `pad_to` with zero columns (a rank's heads at a width
    K5's 128-column tiles do not divide; nothing reads them)."""
    pad = -3 * wq.shape[1] % pad_to
    w = torch.cat([wq.to(dtype), wk.to(dtype), wv.to(dtype),
                   wq.new_zeros(wq.shape[0], pad, dtype=dtype)], dim=1).contiguous()
    b = torch.cat([bq.to(dtype), torch.zeros_like(bq, dtype=dtype), bv.to(dtype),
                   bq.new_zeros(pad, dtype=dtype)])
    return w, b


def ln_qkv_plain(x, g, bl, w_qkv, b_qkv, eps=1e-5, width=None):
    """The JAX package's _ln_qkv_reference on packed weights (pack_qkv; each
    projection `width` columns wide, default a third of the operand's):
    f32 LayerNorm statistics, then each projection rounded to the compute
    dtype before its bias (k's is zero)."""
    D = width or w_qkv.shape[1] // 3
    qkv = dense(layer_norm(x, g, bl, eps), w_qkv, b_qkv)
    return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:3 * D]


def ln_qkv_launch(x, g, bl, w_qkv, b_qkv, eps=1e-5):
    """jl_ln_qkv on CUDA operands (x bf16 [B, T, d], w_qkv [d, N] and b_qkv
    [N] bf16, contiguous) -> [B, T, N] bf16: ln_rows into a scratch
    allocated here, then the product with the bias in its epilogue. K5's
    launches, and K2's first; raises on a shape or layout the kernels do not
    take. Counts nothing: its callers do."""
    B, T, d = x.shape
    N = w_qkv.shape[1]
    if tuple(w_qkv.shape) != (d, N) or tuple(b_qkv.shape) != (N,):
        raise ValueError(f"LN+QKV weights {tuple(w_qkv.shape)}, {tuple(b_qkv.shape)} "
                         f"do not fit d={d}")
    check_gemm_shapes("ln_qkv", d, (d, N))
    g32, bl32 = (t.to(x.device, torch.float32).contiguous() for t in (g, bl))
    check_aligned("ln_qkv", x, g32, bl32, w_qkv, b_qkv)
    ln = torch.empty_like(x)
    qkv = torch.empty(B, T, N, device=x.device, dtype=torch.bfloat16)
    launch(
        "jl_ln_qkv", x.data_ptr(), g32.data_ptr(), bl32.data_ptr(), w_qkv.data_ptr(),
        b_qkv.data_ptr(), ln.data_ptr(), qkv.data_ptr(), B * T, d, N, float(eps),
    )
    return qkv


def fused_ln_qkv(x, g, bl, w_qkv, b_qkv, eps=1e-5, width=None):
    """K5 wrapper -> (q, k, v), each [B, T, D], from packed weights
    (pack_qkv, maybe padded; serving keeps them,
    ``MultiHeadAttention.qkv_weights``) whose projections are `width` = D
    columns wide (default a third of the operand's). CPU tensors take
    ln_qkv_plain; a CUDA tensor (d % 64 == 0, the packed N % 128 == 0)
    launches ln_qkv_launch (csrc/ln_gemm.cu, which replaces the JAX
    package's ops/fused_mlp.py::fused_ln_qkv) or raises. The three results
    are views of one [B, T, 3D] output, which the flash kernel reads with
    its row stride, so nothing is copied."""
    if x.device.type == "cpu":
        return ln_qkv_plain(x, g, bl, w_qkv, b_qkv, eps, width)
    check_cuda("x", x, torch.bfloat16, 3)
    check_cuda("w_qkv", w_qkv, torch.bfloat16, 2)
    check_cuda("b_qkv", b_qkv, torch.bfloat16, 1)
    refuse_grad("fused_ln_qkv", x, g, bl, w_qkv, b_qkv)
    if (w_qkv.shape[1] % 3 if width is None else 3 * width > w_qkv.shape[1]):
        raise ValueError(f"w_qkv {tuple(w_qkv.shape)} is not [d, 3D] (D={width})")
    D = width or w_qkv.shape[1] // 3
    qkv = ln_qkv_launch(x, g, bl, w_qkv, b_qkv, eps)
    QKV_COUNTER.launches += 1
    return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:3 * D]
