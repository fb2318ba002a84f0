"""K3: the fused LN + MLP + residual sublayer y = x + fc2(GELU(fc1(LN(x)))).

``fused_ln_mlp_residual`` is the wrapper of the CUDA kernel in
``csrc/mlp.cu`` (which replaces the JAX package's
``ops/fused_mlp.py::fused_ln_mlp_residual``; the design note is in the .cu
file). ``ln_mlp_residual_plain`` is the same function in plain PyTorch with
the kernel's rounding points; the wrapper takes it only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .._build import LaunchCounter, check_cuda, launch, refuse_grad
from .numerics import dense, layer_norm

COUNTER = LaunchCounter("fused_ln_mlp_residual")
MODEL_WIDTHS = (256, 512, 768, 1024)  # the kernel's template instances


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
    COUNTER.launches += 1
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
