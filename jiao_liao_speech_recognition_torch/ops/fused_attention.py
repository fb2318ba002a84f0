"""K2: the fused self-attention sublayer y = x + out_proj(MHA(LN(x))).

``fused_attention_sublayer`` is the wrapper of K2's CUDA launches
(``fused_attention_sublayer_packed`` on packed q/k/v operands, which
serving keeps), which together replace the JAX package's
``ops/fused_attention.py::fused_attention_sublayer`` and its
head-group-split variant: ``ln_rows`` and the q/k/v GEMM + bias (K5's two
launches, ``csrc/ln_gemm.cu``), the attention core (``jl_attention_core``,
a TMA + wgmma kernel of ``csrc/flash_attention.cu``, whose design note says
why it walks the keys twice), then the out-projection GEMM with K2's
residual epilogue (``jl_attn_out_proj``, ``csrc/ln_gemm.cu``).
``attention_sublayer_plain`` is the same function in plain PyTorch with the
kernels' rounding points; ``attention_core_plain`` and
``attn_out_residual_plain`` are the plain versions of the last two launches
(``fused_mlp.ln_rows_plain`` and ``qkv_gemm_plain`` of the first two), and
every rounding point between them is a bf16 tensor, so they compose to the
sublayer bit for bit. The wrapper takes the plain version only for tensors
on the CPU.

Where K2 does not fit (d = 1280, Whisper large-v3, which the TPU serves with
the head-group-split kernel), the sublayer is K5 (``ops/fused_mlp.py``),
the flash kernel and ``out_proj_residual`` (``csrc/ln_gemm.cu``'s GEMM with
its residual epilogue): hand-written launches throughout.

Under tensor parallelism (parallel/tp.py) a rank holds its heads' columns
of wq / wk / wv and its rows of wo, and the sublayer splits at the
out-projection, the row-parallel product: ``row_partial`` (jl_row_partial,
a new instance of ``csrc/ln_gemm.cu``'s persistent GEMM whose epilogue
stores the f32 accumulator; ``row_partial_plain``) gives the rank's f32
partial, the ranks' partials are summed, and ``attn_residual_after_sum``
(K2's order) or ``residual_after_sum`` (K2h-out's and K3's) round the sum
once and add the bias and the residual. Before it, K2's route runs
``attention_core_tp`` (K2's first three launches on the rank's heads) and
the K5 -> K6 route runs them on the rank's heads.
``row_parallel_product`` is the partial under autograd (the plain
backward), as training's row-parallel layers take it.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import LaunchCounter, check_aligned, check_cuda, launch, refuse_grad
from .fused_mlp import (fc2_residual_plain, ln_qkv_launch, ln_rows_plain, pack_qkv,
                        qkv_gemm_plain)
from .numerics import dense, full_f32, layer_norm, matmul

COUNTER = LaunchCounter("fused_attention_sublayer")
HEAD_WIDTHS = (64, 128)  # the attention core's template instances
# csrc/flash_attention.cu's kCoreKeys: keys of a tile of the attention core
# (and, as kRows, the queries a block owns)
CORE_KEYS = 128
MAX_WIDTH = 1024  # K2's documented range: d <= 1024


def attention_sublayer_fits(d: int, num_heads: int) -> bool:
    """True when K2 takes this shape on the card: dh in HEAD_WIDTHS,
    d % 128 == 0 (whole output tiles of the GEMMs) and d <= MAX_WIDTH (not
    at d = 1280, which keeps K5 -> K6 -> K2h-out)."""
    dh = d // num_heads
    return (dh * num_heads == d and dh in HEAD_WIDTHS and d % 128 == 0
            and d <= MAX_WIDTH)


def attention_scale(dh: int) -> float:
    """np.float32(1 / sqrt(dh)), the scores' scale in every version."""
    return float(np.float32(1.0 / np.sqrt(dh)))


def _softmax_attention(q, k, v, kv_lengths, num_heads):
    """q, k, v [B, T, D] (compute dtype) -> [B, T, D]: f32 scores times
    attention_scale, keys at or past kv_lengths[b] at finfo(f32).min, f32
    softmax rounded to the compute dtype before P.V, each head's output
    rounded to the compute dtype."""
    dt = q.dtype
    B, T, D = q.shape
    dh = D // num_heads

    def heads(t):  # [B, T, D] -> [B, H, T, dh] f32
        return t.reshape(B, T, num_heads, dh).transpose(1, 2).float()

    lens = torch.clamp(kv_lengths.to(q.device, torch.int64), max=T)
    valid = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    with full_f32():
        logits = (heads(q) @ heads(k).transpose(-1, -2)) * attention_scale(dh)
        logits = torch.where(
            valid[:, None, None, :], logits, torch.finfo(torch.float32).min
        )
        probs = torch.softmax(logits, dim=-1).to(dt)
        attn = (probs.float() @ heads(v)).to(dt)
    return attn.transpose(1, 2).reshape(B, T, D)


def attention_sublayer_plain(
    x, g, bl, wq, bq, wk, wv, bv, wo, bo, kv_lengths, num_heads, eps=1e-5
):
    """x [B, T, d] (compute dtype); Dense kernels [in, out]; k unbiased;
    kv_lengths [B] valid keys. Softmax in f32, probabilities rounded to the
    compute dtype before P.V; y = (x + out) + bo."""
    ln = layer_norm(x, g, bl, eps)
    q, k, v = dense(ln, wq, bq), dense(ln, wk), dense(ln, wv, bv)
    return attn_out_residual_plain(x, _softmax_attention(q, k, v, kv_lengths, num_heads),
                                   wo, bo)


def attention_core_plain(qkv, kv_lengths, num_heads):
    """jl_attention_core: qkv [B, T, 3D] (q | k | v, compute dtype) ->
    the heads' outputs [B, T, D], rounded to the compute dtype."""
    D = qkv.shape[-1] // 3
    return _softmax_attention(qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:],
                              kv_lengths, num_heads)


def attn_out_residual_plain(x, attn, wo, bo):
    """jl_attn_out_proj: bf16(bf16(x + bf16(attn . wo)) + bo), the JAX
    kernel's order (K2h-out and K3's fc2 add the bias first)."""
    return (x + matmul(attn, wo)) + bo.to(x.dtype)


def attention_core_launch(qkv, kv_lengths, num_heads):
    """jl_attention_core on CUDA operands (qkv bf16 [B, T, 3D] contiguous,
    kv_lengths int32 [B] on the card) -> the heads' outputs [B, T, D] bf16.
    K2's third launch; counts nothing: its caller does."""
    B, T, D3 = qkv.shape
    dh = D3 // 3 // num_heads
    attn = torch.empty(B, T, D3 // 3, device=qkv.device, dtype=torch.bfloat16)
    launch("jl_attention_core", qkv.data_ptr(), kv_lengths.data_ptr(), attn.data_ptr(), B, T,
           num_heads, dh, attention_scale(dh))
    return attn


def attn_out_proj_launch(x, attn, wo, bo):
    """jl_attn_out_proj on CUDA operands (x and attn bf16 [B, T, D], wo
    [D, D] and bo [D] bf16, contiguous) -> bf16(bf16(x + bf16(attn . wo))
    + bo). K2's last launch; counts nothing: its caller does."""
    B, T, D = x.shape
    check_aligned("attn_out_proj", x, attn, wo, bo)
    out = torch.empty_like(x)
    launch("jl_attn_out_proj", attn.data_ptr(), x.data_ptr(), wo.data_ptr(), bo.data_ptr(),
           out.data_ptr(), B * T, D)
    return out


def fused_attention_sublayer(
    x, g, bl, wq, bq, wk, wv, bv, wo, bo, kv_lengths, num_heads, eps=1e-5
):
    """K2 wrapper on the layer's own weights. CPU tensors take
    attention_sublayer_plain; a CUDA tensor packs the q/k/v weights
    (pack_qkv) and runs fused_attention_sublayer_packed, or raises."""
    if x.device.type == "cpu":
        return attention_sublayer_plain(
            x, g, bl, wq, bq, wk, wv, bv, wo, bo, kv_lengths, num_heads, eps
        )
    w_qkv, b_qkv = (t.to(x.device) for t in pack_qkv(wq, bq, wk, wv, bv))
    return fused_attention_sublayer_packed(x, g, bl, w_qkv, b_qkv, wo, bo, kv_lengths,
                                           num_heads, eps)


def fused_attention_sublayer_packed(
    x, g, bl, w_qkv, b_qkv, wo, bo, kv_lengths, num_heads, eps=1e-5
):
    """K2 on packed q/k/v operands (pack_qkv; serving keeps them,
    ``MultiHeadAttention.qkv_weights``, beside the out-projection's bf16
    copies, so a serving call copies no weight). CPU tensors take the plain
    version of each launch; a CUDA tensor (x bf16 [B, T, d], d = D =
    num_heads * dh and attention_sublayer_fits) launches the LN + q/k/v
    GEMM, the attention core and the out-projection GEMM (q/k/v and the
    heads' outputs in scratch allocated here), or raises."""
    if x.device.type == "cpu":
        qkv = qkv_gemm_plain(ln_rows_plain(x, g, bl, eps), w_qkv, b_qkv)
        return attn_out_residual_plain(x, attention_core_plain(qkv, kv_lengths, num_heads),
                                       wo, bo)
    check_cuda("x", x, torch.bfloat16, 3)
    refuse_grad("fused_attention_sublayer", x, g, bl, w_qkv, b_qkv, wo, bo)
    B, T, d = x.shape
    D = w_qkv.shape[1] // 3
    if D != d or not attention_sublayer_fits(d, num_heads):
        raise ValueError(f"unsupported attention shape d={d} D={D} heads={num_heads}")
    if kv_lengths.shape != (B,):
        raise ValueError(f"kv_lengths must be [B]={B}, got {tuple(kv_lengths.shape)}")
    dev, bf = x.device, torch.bfloat16
    # .to(...).contiguous() is serving's bf16 copy itself
    w_qkv, b_qkv, wo_b, bo_b = (t.to(dev, bf).contiguous() for t in (w_qkv, b_qkv, wo, bo))
    lens = kv_lengths.to(dev, torch.int32).contiguous()
    qkv = ln_qkv_launch(x, g, bl, w_qkv, b_qkv, eps)
    out = attn_out_proj_launch(x, attention_core_launch(qkv, lens, num_heads), wo_b, bo_b)
    COUNTER.launches += 1
    return out


# --- the tensor-parallel split at the row-parallel product -------------------

ROW_COUNTER = LaunchCounter("row_parallel_partial")
TP_CORE_COUNTER = LaunchCounter("attention_core_tp")


def row_partial_plain(a, w):
    """jl_row_partial: a [..., K] . w [K, N] accumulated in f32 and left
    unrounded (bf16 products are exact in f32)."""
    with full_f32():
        return torch.matmul(a.float(), w.float())


def row_partial(a, w):
    """Wrapper of jl_row_partial (csrc/ln_gemm.cu's GEMM with an epilogue
    that stores the f32 accumulator: no bias, no residual, no rounding), a
    tensor-parallel rank's share of a row-parallel product. CPU tensors take
    row_partial_plain; a CUDA tensor (a bf16 [..., K] contiguous, w [K, N],
    K % 64 == 0, N % 128 == 0) launches the kernel or raises -> f32
    [..., N]."""
    if a.device.type == "cpu":
        return row_partial_plain(a, w)
    if a.dtype != torch.bfloat16 or not a.is_contiguous():
        raise ValueError(f"row_partial: expected a contiguous bf16 CUDA tensor, got {a.dtype}")
    refuse_grad("row_partial", a, w)
    wb = w.to(a.device, torch.bfloat16).contiguous()
    K, N = wb.shape
    if a.shape[-1] != K:
        raise ValueError(f"row_partial: a {tuple(a.shape)} does not fit w {tuple(wb.shape)}")
    if K % 64 or N % 128:
        raise ValueError(f"row_partial: unsupported shape K={K}, N={N} "
                         "(need K % 64 == 0, N % 128 == 0)")
    M = a.numel() // K
    out = torch.empty(*a.shape[:-1], N, device=a.device, dtype=torch.float32)
    check_aligned("row_partial", a, wb, out)
    launch("jl_row_partial", a.data_ptr(), wb.data_ptr(), out.data_ptr(), M, N, K)
    ROW_COUNTER.launches += 1
    return out


class _RowProduct(torch.autograd.Function):
    """The f32 partial a . w with the module path's backward in a's dtype
    (da = dy . w^T, dw = a^T . dy), as a Dense layer's matmul has it."""

    @staticmethod
    def forward(ctx, a, w, kernels):
        ctx.save_for_backward(a, w)
        if kernels and a.dtype == torch.bfloat16:
            return row_partial(a.contiguous(), w.to(a.dtype))
        return row_partial_plain(a, w.to(a.dtype))

    @staticmethod
    def backward(ctx, gy):
        a, w = ctx.saved_tensors
        dt = a.dtype
        g = gy.to(dt)
        da = torch.matmul(g, w.to(dt).t()) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(a.reshape(-1, a.shape[-1]).t(),
                              g.reshape(-1, g.shape[-1])).to(w.dtype)
        return da, dw, None


def row_parallel_product(a, w, kernels: bool = True):
    """A row-parallel layer's f32 partial a . w: jl_row_partial on a bf16
    CUDA tensor with `kernels`, else row_partial_plain; under autograd
    through _RowProduct."""
    if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
        return _RowProduct.apply(a, w, kernels)
    if kernels and a.dtype == torch.bfloat16:
        return row_partial(a.contiguous(), w.to(a.dtype))
    return row_partial_plain(a, w.to(a.dtype))


def residual_after_sum(x, acc, b):
    """K2h-out's and K3's epilogue on the ranks' summed f32 partials:
    x + bf16(bf16(acc) + b)."""
    return x + (acc.to(x.dtype) + b.to(x.dtype))


def attn_residual_after_sum(x, acc, b):
    """K2's epilogue on the ranks' summed f32 partials: bf16(bf16(x +
    bf16(acc)) + b)."""
    return (x + acc.to(x.dtype)) + b.to(x.dtype)


def attention_core_tp(x, g, bl, w_qkv, b_qkv, kv_lengths, num_heads, eps=1e-5):
    """K2's first three launches on a tensor-parallel rank's heads (ln_rows
    and the q/k/v GEMM of ``csrc/ln_gemm.cu`` on the rank's packed q/k/v
    columns, then ``jl_attention_core``) -> the heads' outputs [B, T, D]
    for ``row_partial``. CPU tensors take the plain versions of the
    launches; a CUDA tensor (x bf16 [B, T, d], w_qkv [d, 3D] with 3D % 128
    == 0, D = num_heads * dh, dh in HEAD_WIDTHS) launches them or raises."""
    if x.device.type == "cpu":
        qkv = qkv_gemm_plain(ln_rows_plain(x, g, bl, eps), w_qkv, b_qkv)
        return attention_core_plain(qkv, kv_lengths, num_heads)
    check_cuda("x", x, torch.bfloat16, 3)
    refuse_grad("attention_core_tp", x, g, bl, w_qkv, b_qkv)
    B = x.shape[0]
    N = w_qkv.shape[1]
    if N % (3 * num_heads) or N // 3 // num_heads not in HEAD_WIDTHS:
        raise ValueError(f"attention_core_tp: packed width {N} is not 3 x {num_heads} heads "
                         f"of {HEAD_WIDTHS}")
    if kv_lengths.shape != (B,):
        raise ValueError(f"kv_lengths must be [B]={B}, got {tuple(kv_lengths.shape)}")
    dev, bf = x.device, torch.bfloat16
    w_qkv, b_qkv = (t.to(dev, bf).contiguous() for t in (w_qkv, b_qkv))
    lens = kv_lengths.to(dev, torch.int32).contiguous()
    attn = attention_core_launch(ln_qkv_launch(x, g, bl, w_qkv, b_qkv, eps), lens, num_heads)
    TP_CORE_COUNTER.launches += 1
    return attn


# --- the out-projection + residual where K2 does not fit ----------------------

OUT_COUNTER = LaunchCounter("out_proj_residual")


def out_proj_residual(x, attn, wo, bo):
    """Wrapper of jl_out_proj_residual (csrc/ln_gemm.cu, a TMA-fed wgmma
    GEMM with the bias and residual in its epilogue, the one K3's fc2
    runs): the part of K2's second launch that follows the heads, for the
    K5 -> K6 route. CPU tensors take fused_mlp.fc2_residual_plain (x +
    bf16(bf16(attn . wo) + bo)); CUDA tensors (x and attn bf16 [B, T, D],
    D % 128 == 0) launch the kernel or raise."""
    if x.device.type == "cpu":
        return fc2_residual_plain(x, attn, wo, bo)
    check_cuda("x", x, torch.bfloat16, 3)
    check_cuda("attn", attn, torch.bfloat16, 3)
    refuse_grad("out_proj_residual", x, attn, wo, bo)
    B, T, D = x.shape
    if attn.shape != x.shape or D % 128 or tuple(wo.shape) != (D, D) or bo.shape != (D,):
        raise ValueError(f"unsupported out-projection shape x {tuple(x.shape)} "
                         f"attn {tuple(attn.shape)} wo {tuple(wo.shape)}")
    dev, bf = x.device, torch.bfloat16
    wo_b, bo_b = wo.to(dev, bf).contiguous(), bo.to(dev, bf).contiguous()
    check_aligned("out_proj_residual", x, attn, wo_b, bo_b)
    out = torch.empty_like(x)
    launch("jl_out_proj_residual", attn.data_ptr(), x.data_ptr(), wo_b.data_ptr(),
           bo_b.data_ptr(), out.data_ptr(), B * T, D)
    OUT_COUNTER.launches += 1
    return out


# --- K7 (attention half): WF-adapted serving ---------------------------------

WF_COUNTER = LaunchCounter("fused_attention_sublayer_wf")
WF_PROJECTIONS = (("q", "wq"), ("k", "wk"), ("v", "wv"), ("o", "wo"))


def fold_wf(w, f, wf_scale: float):
    """Effective weight W + wf_scale * A diag(g) B in f32 (the JAX package's
    _fold_wf, which runs outside any kernel). f = {"a", "g", "b"}."""
    with full_f32():
        return w.float() + wf_scale * ((f["a"].float() * f["g"].float()[None, :]) @ f["b"].float())


def _folded(base, wf, wf_scale):
    w = dict(base)
    for name, key in WF_PROJECTIONS:
        w[key] = fold_wf(base[key], wf[name], wf_scale)
    return w


def attention_sublayer_wf_plain(x, g, bl, base, wf, num_heads, eps, wf_scale, kv_lengths):
    """The fold, then attention_sublayer_plain. base = {wq, bq, wk, wv, bv,
    wo, bo}; wf = {q|k|v|o: {a, g, b}} (the WFDense parameter layout)."""
    w = _folded(base, wf, wf_scale)
    return attention_sublayer_plain(
        x, g, bl, w["wq"], w["bq"], w["wk"], w["wv"], w["bv"], w["wo"], w["bo"],
        kv_lengths, num_heads, eps,
    )


def fused_attention_sublayer_wf(x, g, bl, base, wf, num_heads, eps, wf_scale, kv_lengths):
    """K7 wrapper (attention): the fold in f32, then the unadapted
    sublayer's launches on the folded weights: K2 where it fits, else (d =
    1280) K5, K6 and ``out_proj_residual``, the route of the unadapted
    large-v3 encoder. CPU tensors take attention_sublayer_wf_plain; CUDA
    tensors launch the kernels or raise."""
    if x.device.type == "cpu":
        return attention_sublayer_wf_plain(
            x, g, bl, base, wf, num_heads, eps, wf_scale, kv_lengths
        )
    refuse_grad("fused_attention_sublayer_wf", x, *base.values(),
                *(t for f in wf.values() for t in f.values()))
    w = _folded(base, wf, wf_scale)
    if attention_sublayer_fits(x.shape[2], num_heads):
        out = fused_attention_sublayer(
            x, g, bl, w["wq"], w["bq"], w["wk"], w["wv"], w["bv"], w["wo"], w["bo"],
            kv_lengths, num_heads, eps,
        )
    else:
        from .flash_attention import flash_attention_packed
        from .fused_mlp import fused_ln_qkv

        bf = torch.bfloat16
        q, k, v = fused_ln_qkv(x, g, bl, *pack_qkv(w["wq"], w["bq"], w["wk"], w["wv"], w["bv"],
                                                   bf), eps)
        attn = flash_attention_packed(q, k, v, num_heads, kv_lengths=kv_lengths)
        out = out_proj_residual(x, attn, w["wo"].to(bf), w["bo"].to(bf))
    WF_COUNTER.launches += 1
    return out
