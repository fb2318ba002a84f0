"""Encoder building blocks, the PyTorch twin of the JAX package's
``models/layers.py`` (encoder subset: no cross-attention, KV cache or
adapters).

Parameters are f32 and named as in the flax tree (``kernel`` [in, out],
``bias``, LayerNorm ``scale``), so ``models/convert.py`` is a rename. The
sublayer arithmetic lives in ``ops/``: each sublayer is one fused kernel on
the card with its plain PyTorch version beside it. What the JAX gates at
``TransformerBlock`` decide carries over: bf16 inference runs the fused
sublayers (K2, K3) on a CUDA tensor; float32 models, CPU tensors and
``kernels=False`` run the plain versions.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
from torch import nn

from ..ops.fused_attention import attention_sublayer_plain, fused_attention_sublayer
from ..ops.fused_mlp import fused_ln_mlp_residual, ln_mlp_residual_plain
from ..ops.numerics import layer_norm


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: truncated normal (+-2 std) with variance
    1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


@lru_cache(maxsize=8)
def sinusoidal_positions(
    length: int, dim: int, dtype: torch.dtype = torch.float32, device: str = "cpu"
) -> torch.Tensor:
    """[length, dim] table: first half sin, second half cos (Whisper layout),
    the JAX numpy formula including its /(dim//2 - 1)."""
    if dim % 2:
        raise ValueError(f"positions need an even width, got {dim}")
    log_timescale = np.log(10000.0) / (dim // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(dim // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)
    return torch.from_numpy(table).to(device=device, dtype=dtype)


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, 1, 1, max_len] bool mask (True = valid)."""
    valid = torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]
    return valid[:, None, None, :]


class Dense(nn.Module):
    """flax nn.Dense parameters: kernel [in, out] and an optional bias."""

    def __init__(self, d_in: int, d_out: int, gen: torch.Generator, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(d_in, d_out), d_in, gen))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics, eps 1e-5, output in the input dtype."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


class MultiHeadAttention(nn.Module):
    """Self-attention projections, Whisper bias convention (k unbiased).
    Its arithmetic is ops/fused_attention.py (TransformerBlock calls it)."""

    def __init__(self, d_model: int, num_heads: int, gen: torch.Generator):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.q_proj = Dense(d_model, d_model, gen)
        self.k_proj = Dense(d_model, d_model, gen, bias=False)
        self.v_proj = Dense(d_model, d_model, gen)
        self.out_proj = Dense(d_model, d_model, gen)


class MLP(nn.Module):
    """fc1 -> GELU (tanh or erf form) -> fc2 parameters. Its arithmetic is
    ops/fused_mlp.py (TransformerBlock calls it)."""

    def __init__(self, d_model: int, mlp_dim: int, gen: torch.Generator, gelu_form: str):
        super().__init__()
        self.fc1 = Dense(d_model, mlp_dim, gen)
        self.fc2 = Dense(mlp_dim, d_model, gen)
        self.gelu_form = gelu_form


class TransformerBlock(nn.Module):
    """Pre-LN block: x + MHA(LN(x)), then x + MLP(LN(x))."""

    def __init__(
        self, d_model: int, num_heads: int, mlp_dim: int, gen: torch.Generator,
        gelu_form: str = "erf",
    ):
        super().__init__()
        self.self_attn_ln = LayerNorm(d_model)
        self.self_attn = MultiHeadAttention(d_model, num_heads, gen)
        self.mlp_ln = LayerNorm(d_model)
        self.mlp = MLP(d_model, mlp_dim, gen, gelu_form)

    def forward(
        self, x: torch.Tensor, kv_lengths: torch.Tensor, kernels: bool = True
    ) -> torch.Tensor:
        """x [B, T, d] in the compute dtype; kv_lengths [B] valid frames."""
        fused = kernels and x.dtype == torch.bfloat16
        attn = fused_attention_sublayer if fused else attention_sublayer_plain
        mlp = fused_ln_mlp_residual if fused else ln_mlp_residual_plain
        sa, ln = self.self_attn, self.self_attn_ln
        x = attn(
            x, ln.scale, ln.bias,
            sa.q_proj.kernel, sa.q_proj.bias, sa.k_proj.kernel,
            sa.v_proj.kernel, sa.v_proj.bias, sa.out_proj.kernel, sa.out_proj.bias,
            kv_lengths, sa.num_heads, ln.eps,
        )
        ln = self.mlp_ln
        return mlp(
            x, ln.scale, ln.bias,
            self.mlp.fc1.kernel, self.mlp.fc1.bias,
            self.mlp.fc2.kernel, self.mlp.fc2.bias,
            ln.eps, self.mlp.gelu_form,
        )
