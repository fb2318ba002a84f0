"""Numerics shared by the plain PyTorch versions of the kernels.

The contract is the JAX package's: f32 LayerNorm statistics, matrix
products of compute-dtype operands accumulated in f32 and rounded to the
compute dtype before a bias is added. In float32 every rounding is a no-op.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Full-f32 matmuls and convolutions on the card: no TF32 anywhere.
    (cuBLAS defaults to full f32, but cuDNN convolutions default to TF32.)"""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5):
    """LayerNorm over the last axis with f32 statistics, output in x.dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return ((xc * torch.rsqrt(var + eps)) * g.float() + b.float()).to(x.dtype)


def matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with w cast to a.dtype, f32 accumulation, result in a.dtype."""
    with full_f32():
        return (a.float() @ w.to(a.dtype).float()).to(a.dtype)


def dense(a: torch.Tensor, w: torch.Tensor, bias=None) -> torch.Tensor:
    """flax nn.Dense(dtype=a.dtype): rounded product, then + rounded bias."""
    y = matmul(a, w)
    return y if bias is None else y + bias.to(a.dtype)
