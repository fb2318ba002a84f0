"""K3: the fused LN + MLP + residual sublayer y = x + fc2(GELU(fc1(LN(x)))),
and K5: the fused LN + q/k/v projections.

``fused_ln_mlp_residual`` is the wrapper of the CUDA kernel in
``csrc/mlp.cu`` (which replaces the JAX package's
``ops/fused_mlp.py::fused_ln_mlp_residual`` and, at d=1280, its chunked
K3c; the design note is in the .cu file). ``fused_ln_qkv`` wraps the
``jl_ln_qkv`` launch of ``csrc/attention.cu`` (the JAX package's
``fused_ln_qkv``). ``ln_mlp_residual_plain`` and ``ln_qkv_plain`` are the
same functions in plain PyTorch with the kernels' rounding points; the
wrappers take them only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import SMEM_LIMIT, LaunchCounter, align128, check_cuda, launch, refuse_grad
from .numerics import dense, layer_norm

COUNTER = LaunchCounter("fused_ln_mlp_residual")
# the d=1280 instance (the TPU's chunked K3c) counts its launches apart
K3C_COUNTER = LaunchCounter("fused_ln_mlp_residual_d1280")
MODEL_WIDTHS = (256, 512, 768, 1024, 1280)  # the kernel's template instances


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


def ln_mlp_residual_plain(x, g, bl, w1, b1, w2, b2, eps=1e-5, gelu_form="tanh"):
    """x [B, T, d] (compute dtype); w1 [d, mlp], w2 [mlp, d]. GELU runs in
    f32 on the rounded fc1 output; y = x + (fc2 + b2)."""
    dt = x.dtype
    h = dense(layer_norm(x, g, bl, eps), w1, b1)
    h = gelu_f32(h.float(), gelu_form).to(dt)
    return x + dense(h, w2, b2)


def fused_ln_mlp_residual(x, g, bl, w1, b1, w2, b2, eps=1e-5, gelu_form="tanh"):
    """K3 wrapper. CPU tensors take ln_mlp_residual_plain; a CUDA tensor
    launches the kernel (x bf16 [B, T, d], d in MODEL_WIDTHS,
    mlp % 128 == 0) or raises."""
    if x.device.type == "cpu":
        return ln_mlp_residual_plain(x, g, bl, w1, b1, w2, b2, eps, gelu_form)
    check_cuda("x", x, torch.bfloat16, 3)
    refuse_grad("fused_ln_mlp_residual", x, g, bl, w1, b1, w2, b2)
    B, T, d = x.shape
    mlp = w1.shape[1]
    if d not in MODEL_WIDTHS or mlp % 128 or tuple(w2.shape) != (mlp, d):
        raise ValueError(f"unsupported MLP shape d={d} mlp={mlp}")
    if gelu_form not in ("tanh", "erf"):
        raise ValueError(f"unknown gelu_form {gelu_form!r} (want 'tanh'|'erf')")
    dev, bf = x.device, torch.bfloat16
    g32 = g.to(dev, torch.float32).contiguous()
    bl32 = bl.to(dev, torch.float32).contiguous()
    w1b, b1b = w1.to(dev, bf).contiguous(), b1.to(dev, bf).contiguous()
    w2b, b2b = w2.to(dev, bf).contiguous(), b2.to(dev, bf).contiguous()
    out = torch.empty_like(x)
    launch(
        "jl_ln_mlp_residual", x.data_ptr(), g32.data_ptr(), bl32.data_ptr(),
        w1b.data_ptr(), b1b.data_ptr(), w2b.data_ptr(), b2b.data_ptr(), out.data_ptr(),
        B * T, d, mlp, int(gelu_form == "erf"), float(eps),
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


def pack_qkv(wq, bq, wk, wv, bv, dtype=torch.bfloat16):
    """-> ([d, 3D] kernel, [3D] bias) in `dtype`: [Wq | Wk | Wv] and
    [bq | 0 | bv], the operands K5 takes (k has no bias)."""
    w = torch.cat([wq.to(dtype), wk.to(dtype), wv.to(dtype)], dim=1).contiguous()
    b = torch.cat([bq.to(dtype), torch.zeros_like(bq, dtype=dtype), bv.to(dtype)])
    return w, b


def ln_qkv_plain(x, g, bl, w_qkv, b_qkv, eps=1e-5):
    """The JAX package's _ln_qkv_reference on packed weights (pack_qkv):
    f32 LayerNorm statistics, then each projection rounded to the compute
    dtype before its bias (k's is zero)."""
    D = w_qkv.shape[1] // 3
    qkv = dense(layer_norm(x, g, bl, eps), w_qkv, b_qkv)
    return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]


def ln_qkv_smem(d: int) -> int:
    """Shared memory of one jl_ln_qkv block: the [64, d + 8] bf16 LN tile
    and a [64, 132] f32 product tile (csrc/attention.cu)."""
    return align128(64 * (d + 8) * 2) + 64 * 132 * 4


def fused_ln_qkv(x, g, bl, w_qkv, b_qkv, eps=1e-5):
    """K5 wrapper -> (q, k, v), each [B, T, D], from packed weights
    (pack_qkv; serving keeps them, ``MultiHeadAttention.qkv_weights``). CPU
    tensors take ln_qkv_plain; a CUDA tensor launches jl_ln_qkv
    (csrc/attention.cu, the first launch of K2, which replaces the JAX
    package's ops/fused_mlp.py::fused_ln_qkv) or raises. The three results
    are views of one [B, T, 3D] output, which the flash kernel reads with
    its row stride, so nothing is copied."""
    if x.device.type == "cpu":
        return ln_qkv_plain(x, g, bl, w_qkv, b_qkv, eps)
    check_cuda("x", x, torch.bfloat16, 3)
    check_cuda("w_qkv", w_qkv, torch.bfloat16, 2)
    check_cuda("b_qkv", b_qkv, torch.bfloat16, 1)
    refuse_grad("fused_ln_qkv", x, g, bl, w_qkv, b_qkv)
    B, T, d = x.shape
    D = w_qkv.shape[1] // 3
    if (d % 16 or (3 * D) % 128 or ln_qkv_smem(d) > SMEM_LIMIT
            or tuple(w_qkv.shape) != (d, 3 * D) or tuple(b_qkv.shape) != (3 * D,)):
        raise ValueError(f"unsupported LN+QKV shape d={d} w_qkv {tuple(w_qkv.shape)}")
    dev, bf = x.device, torch.bfloat16
    g32 = g.to(dev, torch.float32).contiguous()
    bl32 = bl.to(dev, torch.float32).contiguous()
    qkv = torch.empty(B, T, 3 * D, device=dev, dtype=bf)
    launch(
        "jl_ln_qkv", x.data_ptr(), g32.data_ptr(), bl32.data_ptr(), w_qkv.data_ptr(),
        b_qkv.data_ptr(), qkv.data_ptr(), B * T, d, 3 * D, float(eps),
    )
    QKV_COUNTER.launches += 1
    return qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
