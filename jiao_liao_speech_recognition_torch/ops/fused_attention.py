"""K2: the fused self-attention sublayer y = x + out_proj(MHA(LN(x))).

``fused_attention_sublayer`` is the wrapper of the CUDA kernel in
``csrc/attention.cu`` (which replaces the JAX package's
``ops/fused_attention.py::fused_attention_sublayer`` and its head-group-split
variant; the design note is in the .cu file). ``attention_sublayer_plain``
is the same function in plain PyTorch with the kernel's rounding points; the
wrapper takes it only for tensors on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import LaunchCounter, check_cuda, launch, refuse_grad
from .numerics import dense, full_f32, layer_norm, matmul

COUNTER = LaunchCounter("fused_attention_sublayer")
HEAD_WIDTHS = (64, 128)  # the kernel's template instances
MAX_D = 768  # shared memory holds the [64, D] bf16 head outputs of a tile


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
    launches the kernel (x bf16 [B, T, d], d = D = num_heads * dh with
    dh in HEAD_WIDTHS, d % 128 == 0, d <= MAX_D) or raises."""
    if x.device.type == "cpu":
        return attention_sublayer_plain(
            x, g, bl, wq, bq, wk, wv, bv, wo, bo, kv_lengths, num_heads, eps
        )
    check_cuda("x", x, torch.bfloat16, 3)
    refuse_grad("fused_attention_sublayer", x, g, bl, wq, bq, wk, wv, bv, wo, bo)
    B, T, d = x.shape
    D = wq.shape[1]
    dh = D // num_heads
    if D != d or dh * num_heads != D or dh not in HEAD_WIDTHS:
        raise ValueError(f"unsupported attention shape d={d} D={D} heads={num_heads}")
    if d % 128 or d > MAX_D:
        raise ValueError(f"d_model {d}: the kernel takes multiples of 128 up to {MAX_D}")
    if kv_lengths.shape != (B,):
        raise ValueError(f"kv_lengths must be [B]={B}, got {tuple(kv_lengths.shape)}")
    dev = x.device
    bf = torch.bfloat16
    w_qkv = torch.cat([wq, wk, wv], dim=1).to(dev, bf).contiguous()
    b_qkv = torch.cat([bq, torch.zeros_like(bq), bv]).to(dev, bf).contiguous()
    g32 = g.to(dev, torch.float32).contiguous()
    bl32 = bl.to(dev, torch.float32).contiguous()
    wo_b = wo.to(dev, bf).contiguous()
    bo_b = bo.to(dev, bf).contiguous()
    lens = kv_lengths.to(dev, torch.int32).contiguous()
    qkv = torch.empty(B * T, 3 * D, device=dev, dtype=bf)
    out = torch.empty_like(x)
    launch(
        "jl_ln_qkv", x.data_ptr(), g32.data_ptr(), bl32.data_ptr(), w_qkv.data_ptr(),
        b_qkv.data_ptr(), qkv.data_ptr(), B * T, d, 3 * D, float(eps),
    )
    launch(
        "jl_attention_out", qkv.data_ptr(), lens.data_ptr(), x.data_ptr(),
        wo_b.data_ptr(), bo_b.data_ptr(), out.data_ptr(), B, T, num_heads, dh,
    )
    COUNTER.launches += 1
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
