"""Encoder building blocks, the PyTorch twin of the JAX package's
``models/layers.py`` (encoder subset: no cross-attention or KV cache).

Parameters are f32 and named as in the flax tree (``kernel`` [in, out],
``bias``, LayerNorm ``scale``, WF inserts under ``adapter_wf``), so
``models/convert.py`` is a rename. ``TransformerBlock`` keeps the JAX
gates' decisions, not their TPU conditions:

* serving (eval mode, autograd off): one fused kernel per sublayer on the
  card, K2 and K3, or K7 for a WF-adapted model; their plain versions for
  float32 models, CPU tensors and ``kernels=False``;
* training, or anything under autograd: the module path (Dense layers,
  attention, GELU, dropout), whose attention takes flash (K6 forward, K8
  backward) in bf16 at Tq >= ``flash_train_min_q`` and the einsum
  formulation otherwise.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as flash
from ..ops.fused_attention import (
    attention_sublayer_plain,
    attention_sublayer_wf_plain,
    fused_attention_sublayer,
    fused_attention_sublayer_wf,
)
from ..ops.fused_mlp import (
    fused_ln_mlp_residual,
    fused_ln_mlp_residual_wf,
    ln_mlp_residual_plain,
    ln_mlp_residual_wf_plain,
)
from ..ops.numerics import full_f32, layer_norm
from ..utils.config import AdapterConfig


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
    """flax nn.Dense parameters (kernel [in, out], optional bias) and its
    module-path forward: compute-dtype operands, the product rounded to the
    compute dtype, then + bias. ``wf`` adds a WF insert (``adapter_wf``)."""

    def __init__(self, d_in: int, d_out: int, gen: torch.Generator, bias: bool = True,
                 wf: Optional[AdapterConfig] = None):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(d_in, d_out), d_in, gen))
        self.bias = nn.Parameter(torch.zeros(d_out)) if bias else None
        if wf is not None:
            from .adapters import WFAdapter

            self.adapter_wf = WFAdapter(wf, d_in, d_out, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.kernel.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        if hasattr(self, "adapter_wf"):
            y = self.adapter_wf(x, y)
        return y


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics, eps 1e-5, output in the input dtype."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


class Dropout(nn.Module):
    """flax nn.Dropout: in training keep each value with probability 1 - p
    and scale it by 1 / (1 - p). The mask comes from a generator seeded by
    the step's seed (``seed``, set by the model for each forward) and this
    site's index (``site``), so a forward recomputed for the backward
    (remat) draws the same mask."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.site = 0
        self.seed: Optional[int] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p <= 0.0:
            return x
        if self.seed is None:
            raise RuntimeError("dropout in training needs a step seed (model(..., dropout_seed=s))")
        gen = torch.Generator(device=x.device)
        gen.manual_seed((self.seed * 1_000_003 + self.site) % (2**63 - 1))
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype, device=x.device))


def dot_product_attention(q, k, v, mask=None, use_flash: bool = False, kv_lengths=None,
                          kernels: bool = True):
    """[B, T, H, dh] attention (the JAX function). mask: broadcastable to
    [B, H, Tq, Tk], True = attend; kv_lengths: [B] valid keys, the channel
    flash reads (a multi-row mask drops them). Flash (K6; K8 under
    autograd) takes bf16 at Tq >= 64 with dh in the kernels' widths and a
    key-validity mask at most; the rest is the einsum formulation with an
    f32 softmax."""
    if kv_lengths is not None and mask is not None and mask.shape[-2] != 1:
        kv_lengths = None
    key_mask_only = mask is None or (mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1)
    if (use_flash and q.shape[1] >= 64 and q.dtype == torch.bfloat16
            and q.shape[-1] in flash.HEAD_WIDTHS and key_mask_only):
        return flash.flash_attention(q, k, v, mask, kv_lengths=kv_lengths, kernels=kernels)
    if mask is None and kv_lengths is not None:
        mask = length_mask(torch.as_tensor(kv_lengths, device=q.device), k.shape[1])
    dt = q.dtype
    with full_f32():
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(dt)
        return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(dt)


class MultiHeadAttention(nn.Module):
    """Self-attention, Whisper bias convention (k unbiased); WF inserts on
    all four projections when the adapter kind is "wf"."""

    def __init__(self, d_model: int, num_heads: int, gen: torch.Generator, dropout: float = 0.0,
                 adapter: Optional[AdapterConfig] = None, use_flash: bool = True,
                 flash_train_min_q: int = 512):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of {num_heads} heads")
        wf = adapter if adapter is not None and adapter.kind == "wf" else None
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.flash_train_min_q = flash_train_min_q
        self.q_proj = Dense(d_model, d_model, gen, wf=wf)
        self.k_proj = Dense(d_model, d_model, gen, bias=False, wf=wf)
        self.v_proj = Dense(d_model, d_model, gen, wf=wf)
        self.out_proj = Dense(d_model, d_model, gen, wf=wf)
        self.dropout = Dropout(dropout) if dropout > 0 else None

    def forward(self, x: torch.Tensor, kv_lengths: torch.Tensor, kernels: bool = True):
        """Module path: x [B, T, d] (already layer-normed)."""
        B, T, d = x.shape
        H = self.num_heads
        q, k, v = (p(x).reshape(B, T, H, d // H) for p in (self.q_proj, self.k_proj, self.v_proj))
        use_flash = self.use_flash and (not self.training or T >= self.flash_train_min_q)
        out = dot_product_attention(q, k, v, kv_lengths=kv_lengths, use_flash=use_flash,
                                    kernels=kernels)
        out = self.out_proj(out.reshape(B, T, d))
        return self.dropout(out) if self.dropout is not None else out

    def wf_params(self):
        """(base, inserts) in the K7 wrappers' layout."""
        base = {"wq": self.q_proj.kernel, "bq": self.q_proj.bias, "wk": self.k_proj.kernel,
                "wv": self.v_proj.kernel, "bv": self.v_proj.bias,
                "wo": self.out_proj.kernel, "bo": self.out_proj.bias}
        inserts = {n: _insert(p) for n, p in (("q", self.q_proj), ("k", self.k_proj),
                                              ("v", self.v_proj), ("o", self.out_proj))}
        return base, inserts


def _insert(dense: Dense):
    f = dense.adapter_wf
    return {"a": f.a, "g": f.g, "b": f.b}


class MLP(nn.Module):
    """fc1 -> GELU (tanh or erf form) -> dropout -> fc2, WF inserts on both
    Dense layers when the adapter kind is "wf"."""

    def __init__(self, d_model: int, mlp_dim: int, gen: torch.Generator, gelu_form: str,
                 dropout: float = 0.0, adapter: Optional[AdapterConfig] = None):
        super().__init__()
        wf = adapter if adapter is not None and adapter.kind == "wf" else None
        self.fc1 = Dense(d_model, mlp_dim, gen, wf=wf)
        self.fc2 = Dense(mlp_dim, d_model, gen, wf=wf)
        self.gelu_form = gelu_form
        self.dropout = Dropout(dropout) if dropout > 0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.fc1(x), approximate="tanh" if self.gelu_form == "tanh" else "none")
        if self.dropout is not None:
            h = self.dropout(h)
        return self.fc2(h)


class TransformerBlock(nn.Module):
    """Pre-LN block: x + MHA(LN(x)), adapter slot, x + MLP(LN(x)), slot."""

    def __init__(
        self, d_model: int, num_heads: int, mlp_dim: int, gen: torch.Generator,
        gelu_form: str = "erf", dropout: float = 0.0, adapter: Optional[AdapterConfig] = None,
        use_flash: bool = True, flash_train_min_q: int = 512,
    ):
        super().__init__()
        from .adapters import KINDS, AdapterSlot

        ad = adapter or AdapterConfig()
        if ad.kind not in KINDS:
            raise ValueError(f"unknown adapter kind {ad.kind!r}")
        self.adapter = ad
        self.self_attn_ln = LayerNorm(d_model)
        self.self_attn = MultiHeadAttention(d_model, num_heads, gen, dropout, ad, use_flash,
                                            flash_train_min_q)
        self.mlp_ln = LayerNorm(d_model)
        self.mlp = MLP(d_model, mlp_dim, gen, gelu_form, dropout, ad)
        slots = ad.kind in ("bottleneck", "att")
        self.post_attn_slot = AdapterSlot(ad, d_model, gen) if slots and ad.after_attention else None
        self.post_mlp_slot = AdapterSlot(ad, d_model, gen) if slots and ad.after_mlp else None

    def forward(
        self, x: torch.Tensor, kv_lengths: torch.Tensor, kernels: bool = True
    ) -> torch.Tensor:
        """x [B, T, d] in the compute dtype; kv_lengths [B] valid frames."""
        if not self.training and not torch.is_grad_enabled():
            x = self._serve_attention(x, kv_lengths, kernels)
        else:
            x = x + self.self_attn(self.self_attn_ln(x), kv_lengths, kernels)
        if self.post_attn_slot is not None:
            x = self.post_attn_slot(x, kv_lengths, kernels)
        if not self.training and not torch.is_grad_enabled():
            x = self._serve_mlp(x, kernels)
        else:
            x = x + self.mlp(self.mlp_ln(x))
        if self.post_mlp_slot is not None:
            x = self.post_mlp_slot(x, kv_lengths, kernels)
        return x

    def _serve_attention(self, x, kv_lengths, kernels: bool):
        """One fused sublayer: K2 (K7 with WF inserts) for bf16 with
        kernels=True, else the plain version."""
        fused = kernels and x.dtype == torch.bfloat16
        sa, ln = self.self_attn, self.self_attn_ln
        if self.adapter.kind == "wf":
            base, inserts = sa.wf_params()
            fn = fused_attention_sublayer_wf if fused else attention_sublayer_wf_plain
            return fn(x, ln.scale, ln.bias, base, inserts, sa.num_heads, ln.eps,
                      float(self.adapter.scale), kv_lengths)
        fn = fused_attention_sublayer if fused else attention_sublayer_plain
        return fn(
            x, ln.scale, ln.bias,
            sa.q_proj.kernel, sa.q_proj.bias, sa.k_proj.kernel,
            sa.v_proj.kernel, sa.v_proj.bias, sa.out_proj.kernel, sa.out_proj.bias,
            kv_lengths, sa.num_heads, ln.eps,
        )

    def _serve_mlp(self, x, kernels: bool):
        """One fused sublayer: K3 (K7 with WF inserts) or its plain version."""
        fused = kernels and x.dtype == torch.bfloat16
        ln, m = self.mlp_ln, self.mlp
        if self.adapter.kind == "wf":
            fn = fused_ln_mlp_residual_wf if fused else ln_mlp_residual_wf_plain
            return fn(x, ln.scale, ln.bias, m.fc1.kernel, m.fc1.bias, m.fc2.kernel, m.fc2.bias,
                      _insert(m.fc1), _insert(m.fc2), ln.eps, m.gelu_form,
                      float(self.adapter.scale))
        fn = fused_ln_mlp_residual if fused else ln_mlp_residual_plain
        return fn(x, ln.scale, ln.bias, m.fc1.kernel, m.fc1.bias, m.fc2.kernel, m.fc2.bias,
                  ln.eps, m.gelu_form)
