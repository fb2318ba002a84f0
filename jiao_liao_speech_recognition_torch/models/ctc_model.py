"""Conv-subsampled transformer encoder with a CTC head (the flagship), the
PyTorch twin of the JAX package's ``models/ctc_model.py``.

Two stride-2 convs subsample the 100 Hz log-mel 4x (3000 -> 750 frames at
30 s), sinusoidal positions are added, then pre-LN blocks, a final LN and a
linear head over the character vocabulary. Parameters f32, compute in
``cfg.dtype`` (bf16 by default), logits f32. The conv subsampler stays
plain PyTorch (cuDNN), as XLA owned it in the JAX package. Adapters come
from ``cfg.adapter``; ``model.train()`` turns on dropout (masks seeded per
forward by ``dropout_seed``) and, with ``cfg.remat``, recomputes each block
in the backward (``torch.utils.checkpoint``). A limited-context model
(``attention_left_context`` / ``attention_right_context`` >= 0, with
``position_mode="none"`` for sliding-window streaming) masks each block's
attention to a band around every frame.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.fused_head import fused_head_argmax, head_argmax_plain, head_logits, serving_kernel
from ..ops.numerics import full_f32
from ..utils.config import CTCModelConfig
from .layers import (Dropout, LayerNorm, ServingCopy, TransformerBlock, arm_dropout,
                     banded_length_mask, lecun_normal_, sinusoidal_positions)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Conv(nn.Module):
    """Conv1d parameters in torch layout: weight [out, in, k], bias [out]."""

    def __init__(self, c_in: int, c_out: int, k: int, gen: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(
            lecun_normal_(torch.empty(c_in, c_out, k), c_in * k, gen).permute(1, 0, 2).contiguous()
        )
        self.bias = nn.Parameter(torch.zeros(c_out))


class ConvSubsampler(nn.Module):
    """log2(factor) stride-2 convs (k=3, padding 1) + exact-erf GELU:
    [B, mels, T] -> [B, ceil(T / factor), d_model]."""

    def __init__(self, num_mels, d_model, channels, factor, gen):
        super().__init__()
        n = max(factor, 2).bit_length() - 1
        if (1 << n) != factor:
            raise ValueError(f"subsample_factor must be a power of 2, got {factor}")
        c_in = num_mels
        for i in range(n):
            c_out = d_model if i == n - 1 else channels
            self.add_module(f"conv{i + 1}", Conv(c_in, c_out, 3, gen))
            c_in = c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, mels, T] in the compute dtype. Each conv rounds its output
        to that dtype before the bias add, as flax nn.Conv does."""
        dt = x.dtype
        for conv in self.children():
            with full_f32():
                x = F.conv1d(x, conv.weight.to(dt), None, stride=2, padding=1)
            x = F.gelu(x + conv.bias.to(dt)[None, :, None], approximate="none")
        return x.transpose(1, 2).contiguous()


class CTCHead(nn.Module):
    """kernel [d, V], bias [V]: compute-dtype operands, f32 logits. Greedy
    serving (``cast_for_serving``) keeps a copy of the kernel in the compute
    dtype, its columns padded to K4's row pitch (``serving_kernel``); the f32
    bias is read as it is."""

    def __init__(self, d_model: int, vocab_size: int, gen: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(
            lecun_normal_(torch.empty(d_model, vocab_size), d_model, gen)
        )
        self.bias = nn.Parameter(torch.zeros(vocab_size))
        self.serve_dtype = None  # set by cast_for_serving
        self._serve = ServingCopy()

    def cast_for_serving(self, dtype: torch.dtype) -> None:
        self.serve_dtype = dtype
        with torch.no_grad():
            self.weight(dtype)

    def weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The kernel for `dtype` activations: the kept serving copy when
        serving is in `dtype` and autograd is off, else the f32 parameter."""
        if self.serve_dtype != dtype or torch.is_grad_enabled():
            return self.kernel
        return self._serve.get(dtype, (self.kernel,), lambda: serving_kernel(self.kernel, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return head_logits(x, self.kernel, self.bias)

    def argmax_ids(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        """Greedy ids [B, T] int32; K4 for bf16 activations, never storing
        the [B, T, V] logits on the card."""
        kernel = self.weight(x.dtype)
        if kernels and x.dtype == torch.bfloat16:
            return fused_head_argmax(x, kernel, self.bias)
        return head_argmax_plain(x, kernel, self.bias)


class CTCEncoderModel(nn.Module):
    """forward -> (log_probs [B, T', V] f32 | argmax ids [B, T'], lengths [B])."""

    def __init__(self, cfg: CTCModelConfig, device="cpu", seed: int = 0):
        super().__init__()
        if cfg.position_mode not in ("sinusoidal", "none"):
            raise ValueError(f"unknown position_mode {cfg.position_mode!r}")
        if cfg.dtype not in DTYPES:
            raise ValueError(f"unknown compute dtype {cfg.dtype!r}")
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.subsample = ConvSubsampler(
            cfg.num_mels, cfg.d_model, cfg.conv_channels, cfg.subsample_factor, gen
        )
        self.dropout = Dropout(cfg.dropout) if cfg.dropout > 0 else None
        adapter = cfg.adapter if cfg.adapter.kind != "none" else None
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg.d_model, cfg.num_heads, cfg.mlp_dim, gen, cfg.gelu_form,
                             cfg.dropout, adapter, cfg.use_flash_attention, cfg.flash_train_min_q)
            for _ in range(cfg.num_layers)
        )
        self.final_ln = LayerNorm(cfg.d_model)
        self.ctc_head = CTCHead(cfg.d_model, cfg.vocab_size, gen)
        self._dropouts = [m for m in self.modules() if isinstance(m, Dropout)]
        for site, m in enumerate(self._dropouts):
            m.site = site
        self.to(device)

    def forward(
        self,
        features: torch.Tensor,  # [B, num_mels, T] log-mel
        feature_lengths: Optional[torch.Tensor] = None,  # [B] valid frames
        head_mode: str = "log_probs",  # "log_probs" | "argmax_ids"
        kernels: bool = True,
        dropout_seed: Optional[int] = None,  # needed in training when dropout > 0
    ):
        cfg = self.cfg
        if head_mode not in ("log_probs", "argmax_ids"):
            raise ValueError(f"unknown head_mode {head_mode!r}")
        arm_dropout(self._dropouts, dropout_seed)
        remat = cfg.remat and self.training and torch.is_grad_enabled()
        x, out_lengths = encoder_trunk(cfg, self.subsample, self.blocks, features,
                                       feature_lengths, kernels, self.dropout, remat)
        x = self.final_ln(x)
        if head_mode == "argmax_ids":
            return self.ctc_head.argmax_ids(x, kernels), out_lengths
        return torch.log_softmax(self.ctc_head(x), dim=-1), out_lengths

    def frame_ids(self, features: torch.Tensor, feature_lengths: Optional[torch.Tensor] = None,
                  kernels: bool = True):
        """-> (per-frame greedy ids [B, T'] int32, valid frames [B]): what
        greedy decoding, timestamps and streaming read (K4 on the card)."""
        return self(features, feature_lengths, head_mode="argmax_ids", kernels=kernels)


def encoder_trunk(cfg, subsample: ConvSubsampler, blocks, features: torch.Tensor,
                  feature_lengths: Optional[torch.Tensor], kernels: bool,
                  dropout: Optional[nn.Module] = None, remat: bool = False):
    """The conv-subsampled transformer trunk the CTC and joint encoders
    share: features [B, num_mels, T] -> (x [B, T', d] before the final LN,
    valid frames [B] int32). Positions per ``cfg.position_mode``;
    ``cfg.attention_left_context`` / ``_right_context`` >= 0 give every
    block the banded mask and no lengths."""
    dt = DTYPES[cfg.dtype]
    B, _, T = features.shape
    if T > cfg.max_frames:
        raise ValueError(
            f"input has {T} frames > max_frames={cfg.max_frames}; raise "
            f"{type(cfg).__name__}.max_frames or chunk the audio"
        )
    if feature_lengths is None:
        feature_lengths = torch.full((B,), T, dtype=torch.int32)
    out_lengths = feature_lengths.to(features.device, torch.int32)
    f = cfg.subsample_factor
    while f > 1:  # ceil-halving through the stride-2 convs (pad 1)
        out_lengths = (out_lengths + 1) // 2
        f //= 2
    x = subsample(features.to(dt))
    if cfg.position_mode == "sinusoidal":
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, dt, str(x.device))[None]
    if dropout is not None:
        x = dropout(x)
    L, R = cfg.attention_left_context, cfg.attention_right_context
    if L >= 0 or R >= 0:
        # streaming-matched band: every block gets the [B, 1, T', T']
        # mask and no lengths (the band carries what lengths cannot), so
        # attention takes the module path; K3 still serves the MLP
        attn_lens, mask = None, banded_length_mask(out_lengths, x.shape[1], L, R)
    else:
        attn_lens, mask = out_lengths, None
    for block in blocks:
        if remat:
            # the dropout sites keep their own generators (layers.Dropout):
            # no default generator state to save, which a capture refuses
            x = checkpoint(block, x, attn_lens, kernels, mask, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = block(x, attn_lens, kernels, mask)
    return x, out_lengths
