"""Whisper encoder-decoder, the PyTorch twin of the JAX package's
``models/whisper.py``.

Encoder: Conv1d(k3, p1) and Conv1d(k3, s2, p1) with exact GELU (3000 mel
frames -> 1500 positions), fixed sinusoidal positions, pre-LN blocks, a
final LayerNorm. Decoder: token embedding tied to the output head, learned
positions, causal self-attention + cross-attention blocks. Parameters f32,
compute in ``cfg.dtype``; in bf16 the logits are bf16, as the JAX tied head
gives them (``jnp.dot`` of two bf16 operands).

On the card a serving encoder block runs K5, K6 and the out-projection plus
residual kernel (K2 does not fit at d=1280), then K3; a decode step runs K9 for
self- and cross-attention in every block over head-major caches, whose
horizon is padded once to a multiple of 128 (``init_cache``). Random init
happens on the target device from a seeded generator.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.decode_attention import pad_time_to_tk, round_tk
from ..ops.numerics import full_f32
from ..utils.config import WhisperConfig
from .ctc_model import DTYPES, Conv
from .layers import (
    LayerNorm,
    ServingCopy,
    TransformerBlock,
    length_mask,
    sinusoidal_positions,
)

# the JAX package's packed/head-major crossover, a measurement of XLA's
# einsum on the TPU; it decides the CPU default only: on the card K9 reads
# head-major caches at any batch
HEAD_MAJOR_MIN_BATCH = 16


def _check_adapter(cfg: WhisperConfig) -> None:
    if cfg.adapter.kind != "none":
        raise NotImplementedError(
            f"Whisper with adapter kind {cfg.adapter.kind!r}: the WF-adapted Whisper "
            "comes with the Whisper fine-tuning slice")


class TiedEmbedding(nn.Module):
    """Token embedding [V, D] f32 whose transpose is the output head.
    ``attend`` casts both operands to the compute dtype (nn.Embed.attend)."""

    def __init__(self, vocab_size: int, d_model: int, gen: torch.Generator):
        super().__init__()
        # flax variance_scaling(1.0, "fan_in", "normal", out_axis=0): std 1/sqrt(D)
        self.embedding = nn.Parameter(torch.empty(vocab_size, d_model))
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0 / math.sqrt(d_model), generator=gen)
        self.serve_dtype = None  # set by cast_for_serving
        self._serve = ServingCopy()

    def cast_for_serving(self, dtype: torch.dtype) -> None:
        self.serve_dtype = dtype
        with torch.no_grad():
            self.table(dtype)

    def table(self, dtype: torch.dtype) -> torch.Tensor:
        """The table in `dtype`: the kept serving copy when serving is in
        `dtype` and autograd is off."""
        if self.serve_dtype != dtype or torch.is_grad_enabled():
            return self.embedding.to(dtype)
        return self._serve.get(dtype, (self.embedding,), lambda: self.embedding.to(dtype))

    def forward(self, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.table(dtype)[tokens.long()]

    def attend(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Logits [..., V] in `dtype` (f32 accumulation)."""
        with full_f32():
            return torch.matmul(x.to(dtype), self.table(dtype).t())


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.conv1 = Conv(cfg.num_mels, cfg.d_model, 3, gen)
        self.conv2 = Conv(cfg.d_model, cfg.d_model, 3, gen)
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg.d_model, cfg.num_heads, cfg.mlp_dim, gen, "erf", cfg.dropout,
                             None, cfg.use_flash_attention, cfg.flash_train_min_q)
            for _ in range(cfg.encoder_layers)
        )
        self.ln_post = LayerNorm(cfg.d_model)

    def forward(self, mel: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        """mel [B, num_mels, T] -> [B, ceil(T / 2), d] in the compute dtype.
        Each conv rounds to that dtype before its bias, as flax nn.Conv."""
        cfg = self.cfg
        dt = DTYPES[cfg.dtype]
        x = mel.to(dt)
        for conv, stride in ((self.conv1, 1), (self.conv2, 2)):
            with full_f32():
                x = F.conv1d(x, conv.weight.to(dt), None, stride=stride, padding=1)
            x = F.gelu(x + conv.bias.to(dt)[None, :, None], approximate="none")
        x = x.transpose(1, 2).contiguous()
        t = x.shape[1]
        if t > cfg.max_source_positions:
            raise ValueError(
                f"{t} encoder positions > max_source_positions={cfg.max_source_positions} "
                "(Whisper's fixed receptive field); chunk the audio to 30 s")
        x = x + sinusoidal_positions(t, cfg.d_model, dt, str(x.device))[None]
        for block in self.blocks:
            x = block(x, None, kernels)
        return self.ln_post(x)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = TiedEmbedding(cfg.vocab_size, cfg.d_model, gen)
        self.embed_positions = nn.Parameter(torch.empty(cfg.max_target_positions, cfg.d_model))
        with torch.no_grad():
            self.embed_positions.normal_(0.0, 0.02, generator=gen)
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg.d_model, cfg.num_heads, cfg.mlp_dim, gen, "erf", cfg.dropout,
                             None, cfg.use_flash_attention, cfg.flash_train_min_q,
                             cross_attention=True)
            for _ in range(cfg.decoder_layers)
        )
        self.ln = LayerNorm(cfg.d_model)

    def forward(self, tokens: torch.Tensor, enc: torch.Tensor,
                enc_lengths: Optional[torch.Tensor] = None, kernels: bool = True):
        """Teacher-forced: tokens [B, S], enc [B, T, d] -> logits [B, S, V]."""
        dt = DTYPES[self.cfg.dtype]
        S = tokens.shape[1]
        x = self.embed_tokens(tokens, dt) + self.embed_positions[:S].to(dt)[None]
        causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=x.device))[None, None]
        enc_mask = length_mask(enc_lengths, enc.shape[1]) if enc_lengths is not None else None
        for block in self.blocks:
            x = block(x, None, kernels, mask=causal, enc=enc, enc_mask=enc_mask,
                      enc_kv_lengths=enc_lengths)
        return self.embed_tokens.attend(self.ln(x), dt)

    def init_cache(self, batch: int, enc: torch.Tensor, max_len: Optional[int] = None,
                   layout: Optional[str] = None) -> Dict:
        """Per-block caches: zeroed self K/V and the cross K/V projected once
        from the encoder output. Head-major [B, H, T, dh] (horizons padded to
        a multiple of 128, so K9 reads them as they are) on a CUDA device or
        at batch >= HEAD_MAJOR_MIN_BATCH; packed [B, T, d] otherwise, or when
        `layout` says so ("packed" | "head_major")."""
        cfg = self.cfg
        dt = DTYPES[cfg.dtype]
        t_cache = cfg.max_target_positions
        if max_len is not None:
            t_cache = min(max_len, t_cache)
        H, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
        if layout is None:
            head_major = enc.device.type == "cuda" or batch >= HEAD_MAJOR_MIN_BATCH
        elif layout in ("packed", "head_major"):
            head_major = layout == "head_major"
        else:
            raise ValueError(f"unknown cache layout {layout!r}")
        caches = {}
        for i, block in enumerate(self.blocks):
            cross = block.precompute_cross(enc)
            if head_major:
                t_enc = cross["k"].shape[1]
                cross = {n: pad_time_to_tk(a.reshape(batch, t_enc, H, dh).transpose(1, 2), 2)
                         .contiguous() for n, a in cross.items()}
                shape = (batch, H, round_tk(t_cache), dh)
            else:
                shape = (batch, t_cache, cfg.d_model)
            zeros = dict(dtype=dt, device=enc.device)
            caches[f"block_{i}"] = {"self": {"k": torch.zeros(shape, **zeros),
                                             "v": torch.zeros(shape, **zeros)},
                                    "cross": cross}
        return caches

    def decode_step(self, token: torch.Tensor, pos: int, enc: torch.Tensor, caches: Dict,
                    enc_lengths: Optional[torch.Tensor] = None, kernels: bool = True):
        """One cached step at position `pos` (every row in lockstep): token
        [B, 1] -> (logits [B, V], caches). The caches are updated in place."""
        dt = DTYPES[self.cfg.dtype]
        B = token.shape[0]
        x = self.embed_tokens(token, dt) + self.embed_positions[pos].to(dt)[None, None]
        t_cache = caches["block_0"]["self"]["k"].shape[-2]
        kmask = (torch.arange(t_cache, device=x.device) <= pos)[None, None, None, :]
        enc_mask = length_mask(enc_lengths, enc.shape[1]) if enc_lengths is not None else None
        lens = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
        for i, block in enumerate(self.blocks):
            c = caches[f"block_{i}"]
            x, c["self"], c["cross"], _ = block(
                x, lens, kernels, mask=kmask, enc=enc, enc_mask=enc_mask,
                self_cache=c["self"], cross_cache=c["cross"], cache_index=pos,
                enc_kv_lengths=enc_lengths)
        return self.embed_tokens.attend(self.ln(x), dt)[:, 0], caches


class WhisperModel(nn.Module):
    """forward(mel, tokens) -> teacher-forced logits [B, S, V]; encode /
    decode / decode_step / init_cache as in the JAX module."""

    def __init__(self, cfg: WhisperConfig, device="cpu", seed: int = 0):
        super().__init__()
        _check_adapter(cfg)
        if cfg.dtype not in DTYPES:
            raise ValueError(f"unknown compute dtype {cfg.dtype!r}")
        self.cfg = cfg
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        with device:  # parameters are made and initialised where they live
            self.encoder = WhisperEncoder(cfg, gen)
            self.decoder = WhisperDecoder(cfg, gen)

    def forward(self, mel, tokens, enc_lengths=None, kernels: bool = True):
        return self.decoder(tokens, self.encoder(mel, kernels), enc_lengths, kernels)

    def encode(self, mel, kernels: bool = True):
        return self.encoder(mel, kernels)

    def decode(self, tokens, enc, enc_lengths=None, kernels: bool = True):
        return self.decoder(tokens, enc, enc_lengths, kernels)

    def decode_step(self, token, pos: int, enc, caches, enc_lengths=None, kernels: bool = True):
        return self.decoder.decode_step(token, pos, enc, caches, enc_lengths, kernels)

    def init_cache(self, batch: int, enc, max_len: Optional[int] = None,
                   layout: Optional[str] = None):
        return self.decoder.init_cache(batch, enc, max_len, layout)
