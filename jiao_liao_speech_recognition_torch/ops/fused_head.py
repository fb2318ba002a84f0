"""K4: the fused CTC head + argmax, ids = argmax_v(x . W + b).

``fused_head_argmax`` is the wrapper of the CUDA kernel in
``csrc/head.cu`` (which replaces the JAX package's
``ops/fused_head.py::fused_head_argmax``; the design note is in the .cu
file): a TMA + wgmma GEMM over 128 x 128 tiles whose epilogue keeps each
tile's (max, first column) per row, then a launch that merges the tiles.
``head_argmax_plain`` is the same function in plain PyTorch; the wrapper
takes it only for CPU tensors.

The kernel reads W as bf16 [d, ldw] through a tensor map, whose row pitch
must be a multiple of 16 bytes: ``serving_kernel`` makes that copy once
(columns padded to a multiple of 8; ``CTCHead`` keeps it), and columns at
or past V = len(bias) are ignored everywhere, in the plain version too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._build import LaunchCounter, check_aligned, check_cuda, launch, refuse_grad
from .numerics import full_f32

COUNTER = LaunchCounter("fused_head_argmax")
TILE_COLUMNS = 128  # vocabulary columns of one K4 tile: rows of the partials scratch
PITCH = 8  # W's row pitch in bf16 elements must be a multiple of this (16 bytes)


def head_logits(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor):
    """CTC head: x . W with W cast to x.dtype, f32 accumulation, + f32 bias.
    W's columns at or past V = len(bias) (a serving copy's padding) are
    left out."""
    with full_f32():
        w = kernel[:, : bias.shape[0]].to(x.dtype).float()
        return x.float() @ w + bias.float()


def head_argmax_plain(x, kernel, bias):
    """[B, T, d] -> [B, T] int32 ids; ties go to the first index."""
    return torch.argmax(head_logits(x, kernel, bias), dim=-1).to(torch.int32)


def serving_kernel(kernel: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """W [d, V] -> a contiguous `dtype` copy [d, V rounded up to PITCH],
    zero past V: the operand K4 and P2 read without a per-call copy."""
    pad = -kernel.shape[1] % PITCH
    return F.pad(kernel.detach().to(dtype), (0, pad)).contiguous()


def head_operands(symbol, x, kernel, bias):
    """Check a head + argmax kernel's operands (x bf16 [B, T, d] on the card,
    d % 16 == 0, B * T > 0; kernel [d, ldw] with ldw >= V = len(bias);
    bias [V]) -> (w bf16 [d, ldw], b f32 [V]) as the kernel reads them. A
    bf16 kernel is read in place and must be contiguous with 16-byte rows
    (``serving_kernel``); any other dtype is copied that way per call."""
    check_cuda("x", x, torch.bfloat16, 3)
    refuse_grad(symbol, x, kernel, bias)
    B, T, d = x.shape
    if (d % 16 or B * T == 0 or kernel.dim() != 2 or kernel.shape[0] != d or bias.dim() != 1
            or not 0 < bias.shape[0] <= kernel.shape[1]):
        raise ValueError(f"unsupported head shape x={tuple(x.shape)} "
                         f"kernel={tuple(kernel.shape)} bias={tuple(bias.shape)}")
    if kernel.dtype == torch.bfloat16:
        if not kernel.is_contiguous() or kernel.shape[1] % PITCH:
            raise ValueError(f"unsupported head kernel layout {tuple(kernel.shape)}, strides "
                             f"{kernel.stride()}: its rows must be 16-byte multiples "
                             "(ops.fused_head.serving_kernel)")
        w = kernel
    else:
        w = serving_kernel(kernel.to(x.device))
    check_aligned(symbol, x, w)
    return w, bias.to(x.device, torch.float32).contiguous()


def fused_head_argmax(x, kernel, bias):
    """K4 wrapper. CPU tensors take head_argmax_plain; a CUDA tensor
    launches the kernel (two launches over a partials scratch this
    allocates; the operands as ``head_operands`` takes them) or raises."""
    if x.device.type == "cpu":
        return head_argmax_plain(x, kernel, bias)
    w, b = head_operands("jl_head_argmax", x, kernel, bias)
    B, T, d = x.shape
    M, V = B * T, b.shape[0]
    partials = torch.empty(-(-V // TILE_COLUMNS), M, 2, device=x.device, dtype=torch.int32)
    ids = torch.empty(B, T, device=x.device, dtype=torch.int32)
    launch("jl_head_argmax", x.data_ptr(), w.data_ptr(), b.data_ptr(), partials.data_ptr(),
           ids.data_ptr(), M, d, V, w.shape[1])
    COUNTER.launches += 1
    return ids
