"""K2: the fused self-attention sublayer y = x + out_proj(MHA(LN(x))).

``fused_attention_sublayer`` is the wrapper of K2's CUDA launches: LN +
q/k/v (K5's, ``csrc/ln_gemm.cu``), then ``jl_attention_out`` of
``csrc/attention.cu``. Together they replace the JAX package's
``ops/fused_attention.py::fused_attention_sublayer`` and its
head-group-split variant; the design note is in attention.cu.
``attention_sublayer_plain`` is the same function in plain PyTorch with the
kernels' rounding points; the wrapper takes it only for tensors on the CPU.

Where K2 does not fit (d = 1280, Whisper large-v3, which the TPU serves with
the head-group-split kernel), the sublayer is K5 (``ops/fused_mlp.py``),
the flash kernel and ``out_proj_residual`` (``csrc/ln_gemm.cu``'s GEMM with
its residual epilogue): hand-written launches throughout.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import (
    SMEM_LIMIT,
    LaunchCounter,
    align128,
    check_aligned,
    check_cuda,
    launch,
    refuse_grad,
)
from .fused_mlp import fc2_residual_plain, ln_qkv_launch, pack_qkv
from .numerics import dense, full_f32, layer_norm, matmul

COUNTER = LaunchCounter("fused_attention_sublayer")
HEAD_WIDTHS = (64, 128)  # the kernel's template instances


def attention_out_smem(D: int, dh: int) -> int:
    """Shared memory of one jl_attention_out block (csrc/attention.cu): q,
    k, v tiles, f32 scores, bf16 probabilities, the [64, D] bf16 head
    outputs of all heads and the f32 product tile."""
    return (3 * align128(64 * (dh + 8) * 2) + align128(64 * 68 * 4) + align128(64 * 72 * 2)
            + align128(64 * (D + 8) * 2) + 64 * 132 * 4)


def attention_sublayer_fits(d: int, num_heads: int) -> bool:
    """True when K2 takes this shape on the card: dh in HEAD_WIDTHS,
    d % 128 == 0 and its shared memory within one block's limit (not at
    d = 1280: 252,928 bytes)."""
    dh = d // num_heads
    return (dh * num_heads == d and dh in HEAD_WIDTHS and d % 128 == 0
            and attention_out_smem(d, dh) <= SMEM_LIMIT)


def attention_sublayer_plain(
    x, g, bl, wq, bq, wk, wv, bv, wo, bo, kv_lengths, num_heads, eps=1e-5
):
    """x [B, T, d] (compute dtype); Dense kernels [in, out]; k unbiased;
    kv_lengths [B] valid keys. Softmax in f32, probabilities rounded to the
    compute dtype before P.V; y = (x + out) + bo."""
    dt = x.dtype
    B, T, _ = x.shape
    D = wq.shape[1]
    dh = D // num_heads
    ln = layer_norm(x, g, bl, eps)
    q, k, v = dense(ln, wq, bq), dense(ln, wk), dense(ln, wv, bv)

    def heads(t):  # [B, T, D] -> [B, H, T, dh] f32
        return t.reshape(B, T, num_heads, dh).transpose(1, 2).float()

    scale = float(np.float32(1.0 / np.sqrt(dh)))
    lens = torch.clamp(kv_lengths.to(x.device, torch.int64), max=T)
    valid = torch.arange(T, device=x.device)[None, :] < lens[:, None]
    with full_f32():
        logits = (heads(q) @ heads(k).transpose(-1, -2)) * scale
        logits = torch.where(
            valid[:, None, None, :], logits, torch.finfo(torch.float32).min
        )
        probs = torch.softmax(logits, dim=-1).to(dt)
        attn = (probs.float() @ heads(v)).to(dt)
    attn = attn.transpose(1, 2).reshape(B, T, D)
    return (x + matmul(attn, wo)) + bo.to(dt)


def fused_attention_sublayer(
    x, g, bl, wq, bq, wk, wv, bv, wo, bo, kv_lengths, num_heads, eps=1e-5
):
    """K2 wrapper. CPU tensors take attention_sublayer_plain; a CUDA tensor
    launches the kernel (x bf16 [B, T, d], d = D = num_heads * dh and
    attention_sublayer_fits) or raises."""
    if x.device.type == "cpu":
        return attention_sublayer_plain(
            x, g, bl, wq, bq, wk, wv, bv, wo, bo, kv_lengths, num_heads, eps
        )
    check_cuda("x", x, torch.bfloat16, 3)
    refuse_grad("fused_attention_sublayer", x, g, bl, wq, bq, wk, wv, bv, wo, bo)
    B, T, d = x.shape
    D = wq.shape[1]
    dh = D // num_heads
    if D != d or not attention_sublayer_fits(d, num_heads):
        raise ValueError(f"unsupported attention shape d={d} D={D} heads={num_heads}")
    if kv_lengths.shape != (B,):
        raise ValueError(f"kv_lengths must be [B]={B}, got {tuple(kv_lengths.shape)}")
    dev = x.device
    bf = torch.bfloat16
    w_qkv, b_qkv = (t.to(dev) for t in pack_qkv(wq, bq, wk, wv, bv))
    wo_b = wo.to(dev, bf).contiguous()
    bo_b = bo.to(dev, bf).contiguous()
    lens = kv_lengths.to(dev, torch.int32).contiguous()
    qkv = ln_qkv_launch(x, g, bl, w_qkv, b_qkv, eps)
    out = torch.empty_like(x)
    launch(
        "jl_attention_out", qkv.data_ptr(), lens.data_ptr(), x.data_ptr(),
        wo_b.data_ptr(), bo_b.data_ptr(), out.data_ptr(), B, T, num_heads, dh,
    )
    COUNTER.launches += 1
    return out


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
    """K7 wrapper (attention): the fold in f32, then the K2 wrapper. CPU
    tensors take attention_sublayer_wf_plain; CUDA tensors launch K2 or raise."""
    if x.device.type == "cpu":
        return attention_sublayer_wf_plain(
            x, g, bl, base, wf, num_heads, eps, wf_scale, kv_lengths
        )
    refuse_grad("fused_attention_sublayer_wf", x, *base.values(),
                *(t for f in wf.values() for t in f.values()))
    w = _folded(base, wf, wf_scale)
    out = fused_attention_sublayer(
        x, g, bl, w["wq"], w["bq"], w["wk"], w["wv"], w["bv"], w["wo"], w["bo"],
        kv_lengths, num_heads, eps,
    )
    WF_COUNTER.launches += 1
    return out
