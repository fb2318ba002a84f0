"""K4: the fused CTC head + argmax, ids = argmax_v(x . W + b).

``fused_head_argmax`` is the wrapper of the CUDA kernel in
``csrc/head.cu`` (which replaces the JAX package's
``ops/fused_head.py::fused_head_argmax``; the design note is in the .cu
file). ``head_argmax_plain`` is the same function in plain PyTorch; the
wrapper takes it only for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._build import LaunchCounter, check_cuda, launch, refuse_grad
from .numerics import full_f32

COUNTER = LaunchCounter("fused_head_argmax")
MAX_D = 1024  # shared memory holds a [64, d] bf16 row tile


def head_logits(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor):
    """CTC head: x . W with W cast to x.dtype, f32 accumulation, + f32 bias."""
    with full_f32():
        return x.float() @ kernel.to(x.dtype).float() + bias.float()


def head_argmax_plain(x, kernel, bias):
    """[B, T, d] -> [B, T] int32 ids; ties go to the first index."""
    return torch.argmax(head_logits(x, kernel, bias), dim=-1).to(torch.int32)


def launch_head_argmax(symbol, counter, x, kernel, bias, max_d):
    """Check the operands of a head + argmax kernel (K4's ``jl_head_argmax``
    or P2's ``jl_head_argmax_chunked``: x bf16 [B, T, d], d % 16 == 0,
    d <= max_d; kernel [d, V], bias [V]), launch it -> int32 ids [B, T]."""
    check_cuda("x", x, torch.bfloat16, 3)
    refuse_grad(symbol, x, kernel, bias)
    B, T, d = x.shape
    V = kernel.shape[1]
    if d % 16 or d > max_d or kernel.shape[0] != d or tuple(bias.shape) != (V,):
        raise ValueError(f"unsupported head shape d={d} kernel={tuple(kernel.shape)}")
    dev = x.device
    w = kernel.to(dev, torch.bfloat16)
    if V % 16:  # whole 16-column fragments; the kernel ignores columns >= V
        w = F.pad(w, (0, 16 - V % 16))
    w = w.contiguous()
    b32 = bias.to(dev, torch.float32).contiguous()
    ids = torch.empty(B, T, device=dev, dtype=torch.int32)
    launch(symbol, x.data_ptr(), w.data_ptr(), b32.data_ptr(), ids.data_ptr(), B * T, d, V,
           w.shape[1])
    counter.launches += 1
    return ids


def fused_head_argmax(x, kernel, bias):
    """K4 wrapper. CPU tensors take head_argmax_plain; a CUDA tensor
    launches the kernel (x bf16 [B, T, d], d % 16 == 0, d <= MAX_D; kernel
    [d, V], bias [V]) or raises."""
    if x.device.type == "cpu":
        return head_argmax_plain(x, kernel, bias)
    return launch_head_argmax("jl_head_argmax", COUNTER, x, kernel, bias, MAX_D)
