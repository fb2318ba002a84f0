"""Adapters on a frozen backbone, the twin of the JAX package's
``models/adapters.py``: the WF adapter (a low-rank insert W + A diag(g) B on
a backbone Dense), the Att adapter (a small residual attention block) and
the bottleneck baseline, placed by ``AdapterSlot`` after the attention and
MLP sublayers. Every adapter parameter lives under a module named
``adapter_*`` (flax names kept: ``adapter_wf/{a,g,b}``, ``adapter_att/...``,
``adapter_bn/...``), so ``param_is_adapter`` derives the trainable mask
from names alone and ``models/convert.py`` stays a rename.

The Att adapter decodes over its own KV cache (``cache_shape``, packed
[B, T, heads * key_dim], made by the decoders' ``init_cache`` under
``slots``), so a decode step attends over positions 0..pos as the
teacher-forced pass that trained it did.
"""

from __future__ import annotations

import torch
from torch import nn

from ..utils.config import AdapterConfig
from .layers import (Dense, Dropout, LayerNorm, dot_product_attention, lecun_normal_,
                     update_cache_rows)

ADAPTER_PREFIX = "adapter_"
KINDS = ("none", "bottleneck", "wf", "att")


def param_is_adapter(path) -> bool:
    """True if a parameter path (tuple of names, or a dotted state_dict
    key) belongs to an adapter."""
    if isinstance(path, str):
        path = path.split(".")
    return any(isinstance(k, str) and k.startswith(ADAPTER_PREFIX) for k in path)


class WFAdapter(nn.Module):
    """Low-rank insert on a frozen Dense: out + scale * ((x A) * g) B, with
    A [d_in, r] lecun-normal, g [r] ones and B [r, d_out] zeros (identity at
    init). Operands in the compute dtype, as the JAX module casts them."""

    def __init__(self, cfg: AdapterConfig, d_in: int, d_out: int, gen: torch.Generator):
        super().__init__()
        r = cfg.wf_rank
        self.scale = float(cfg.scale)
        self.a = nn.Parameter(lecun_normal_(torch.empty(d_in, r), d_in, gen))
        self.g = nn.Parameter(torch.ones(r))
        self.b = nn.Parameter(torch.zeros(r, d_out))

    def forward(self, x: torch.Tensor, frozen_out: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        z = torch.matmul(x, self.a.to(dt)) * self.g.to(dt)
        return frozen_out + self.scale * torch.matmul(z, self.b.to(dt))


class BottleneckAdapter(nn.Module):
    """h + scale * up(dropout(GELU_erf(down(LN(h))))), up zero-initialised."""

    def __init__(self, cfg: AdapterConfig, d: int, gen: torch.Generator):
        super().__init__()
        self.scale = float(cfg.scale)
        self.ln = LayerNorm(d)
        self.down = Dense(d, cfg.bottleneck_dim, gen)
        self.up = Dense(cfg.bottleneck_dim, d, gen)
        nn.init.zeros_(self.up.kernel)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, h: torch.Tensor, kv_lengths=None, kernels: bool = True,
                mask=None) -> torch.Tensor:
        z = self.down(self.ln(h))
        z = self.dropout(torch.nn.functional.gelu(z, approximate="none"))
        return h + self.scale * self.up(z)


class AttAdapter(nn.Module):
    """h + scale * out(MHA(LN(h))) with att_num_heads heads of att_key_dim;
    one merged qkv projection, out_proj zero-initialised. Attention takes
    flash (K6, and K8 under autograd) in eval mode, or in training at
    Tq >= 512, as the JAX module does."""

    def __init__(self, cfg: AdapterConfig, d: int, gen: torch.Generator):
        super().__init__()
        self.num_heads, self.key_dim = cfg.att_num_heads, cfg.att_key_dim
        self.scale = float(cfg.scale)
        width = self.num_heads * self.key_dim
        self.ln = LayerNorm(d)
        self.qkv_proj = Dense(d, 3 * width, gen)
        self.out_proj = Dense(width, d, gen)
        nn.init.zeros_(self.out_proj.kernel)
        self.dropout = Dropout(cfg.dropout) if cfg.dropout > 0 else None

    def cache_shape(self, batch: int, max_len: int):
        """The packed [batch, max_len, heads * key_dim] shape of its K and V
        caches."""
        return (batch, max_len, self.num_heads * self.key_dim)

    def forward(self, h: torch.Tensor, kv_lengths=None, kernels: bool = True,
                mask=None, kv_cache=None, cache_index=None):
        """mask: the block's mask (a decoder's causal or decode-step key
        mask, a banded [B, 1, T, T] one), else None and kv_lengths. With
        `kv_cache` ({"k", "v"} of ``cache_shape``) this step's K/V rows are
        written at `cache_index` in place and the queries attend over the
        whole cache under `mask` -> (out, kv_cache)."""
        B, Tq, _ = h.shape
        H, dk = self.num_heads, self.key_dim
        q, k, v = self.qkv_proj(self.ln(h)).split(H * dk, dim=-1)
        if kv_cache is not None:
            k = update_cache_rows(kv_cache["k"], k, cache_index, 1)
            v = update_cache_rows(kv_cache["v"], v, cache_index, 1)
        Tk = k.shape[1]
        out = dot_product_attention(
            q.reshape(B, Tq, H, dk), k.reshape(B, Tk, H, dk), v.reshape(B, Tk, H, dk),
            mask, kv_lengths=kv_lengths, use_flash=not self.training or Tq >= 512,
            kernels=kernels,
        )
        out = self.out_proj(out.reshape(B, Tq, H * dk))
        if self.dropout is not None:
            out = self.dropout(out)
        y = h + self.scale * out
        return y if kv_cache is None else (y, kv_cache)


class AdapterSlot(nn.Module):
    """Injection point after a sublayer: holds ``adapter_bn`` or
    ``adapter_att``. The WF kind lives inside the Dense layers instead, so
    a block builds no slot for it."""

    def __init__(self, cfg: AdapterConfig, d: int, gen: torch.Generator):
        super().__init__()
        if cfg.kind == "bottleneck":
            self.adapter_bn = BottleneckAdapter(cfg, d, gen)
        elif cfg.kind == "att":
            self.adapter_att = AttAdapter(cfg, d, gen)
        else:
            raise ValueError(f"no slot adapter for kind {cfg.kind!r}")

    def forward(self, h, kv_lengths=None, kernels: bool = True, mask=None, kv_cache=None,
                cache_index=None):
        """-> h adapted, or (h adapted, kv_cache) with a cache: the Att
        adapter's, updated in place; the bottleneck's, passed through."""
        if hasattr(self, "adapter_att"):
            return self.adapter_att(h, kv_lengths, kernels, mask, kv_cache, cache_index)
        out = self.adapter_bn(h, kv_lengths, kernels, mask)
        return out if kv_cache is None else (out, kv_cache)
