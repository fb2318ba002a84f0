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

Adapters (``cfg.adapter``) sit in every encoder and decoder block as in the
CTC backbone: WF inserts on the attention projections and fc1/fc2, or
bottleneck / Att slots after the sublayers. A WF-adapted encoder serves
through K7 (the inserts folded into the weights, then K5, K6, the
out-projection kernel and K3 on the folded weights); an Att-adapted
decoder keeps a KV cache a slot (``init_cache``'s ``slots``). Training
(``model.train()``, train/engine.py's Whisper loss) takes the module path:
the encoder's self-attention runs flash (K6, K8 backward) at T >=
``flash_train_min_q``, dropout masks are seeded per forward by
``dropout_seed``, and ``cfg.remat`` recomputes each encoder block in the
backward (the JAX module remats the encoder blocks only).

An int8 serving model (``ModelBundle.quantize``: ``Int8Dense`` decoder
layers, ``Int8TiedEmbedding``) runs K10 for its projections, int8 cross
caches through K9's int8 half, int8 self caches where the JAX package
keeps them (batch >= HEAD_MAJOR_MIN_BATCH, or ``layout="head_major"``),
and K11 for f32 logits.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.decode_attention import pad_time_to_tk, round_tk
from ..ops.numerics import full_f32
from ..ops.quant import int8_tied_logits, quantize_int8, quantize_kv
from ..utils.config import WhisperConfig
from .ctc_model import DTYPES, Conv
from .layers import (
    Dropout,
    LayerNorm,
    ServingCopy,
    TransformerBlock,
    arm_dropout,
    is_quantized,
    length_mask,
    sinusoidal_positions,
)

# the JAX package's packed/head-major crossover, a measurement of XLA's
# einsum on the TPU; it decides the CPU default and where int8 self caches
# are kept: on the card K9 reads bf16 head-major caches at any batch
HEAD_MAJOR_MIN_BATCH = 16


def _on_card(t: torch.Tensor) -> bool:
    """The card's cache layout applies (patchable: tests run it on the CPU)."""
    return t.device.type == "cuda"


def _adapter(cfg):
    """The blocks' adapter config, None for kind "none"."""
    return cfg.adapter if cfg.adapter.kind != "none" else None


class TiedEmbedding(nn.Module):
    """Token embedding [V, D] f32 whose transpose is the output head.
    ``attend`` casts both operands to the compute dtype (nn.Embed.attend).

    Vocab-parallel when ``parallel/tp.apply_tp`` split its rows (``tp``
    set, where the group's size divides V, as JAX's rule splits it): a
    rank holds rows [r V / tp, (r + 1) V / tp); a lookup takes this rank's
    rows where the token falls in them and zeros elsewhere, summed over the
    group (exact: one term is not zero); the logits are this rank's columns,
    joined over the group in rank order, so every rank reads the whole
    [.., V] (bitwise the unsplit product's columns)."""

    tp = None

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
        if self.tp is None:
            return self.table(dtype)[tokens.long()]
        table = self.table(dtype)
        rows, inside = masked_rows(lambda t: table[t], tokens, table.shape[0], self.tp.rank)
        return self.tp.reduce(rows * inside[..., None].to(dtype))

    def attend(self, x: torch.Tensor, dtype: torch.dtype, kernels: bool = True) -> torch.Tensor:
        """Logits [..., V] in `dtype` (f32 accumulation). `kernels` is
        Int8TiedEmbedding's switch, taken here for the decoder's one call."""
        if self.tp is not None:
            x = self.tp.enter(x)
        with full_f32():
            logits = torch.matmul(x.to(dtype), self.table(dtype).t())
        return logits if self.tp is None else self.tp.gather(logits, -1)

    def quantized(self) -> "Int8TiedEmbedding":
        """Per-vocab-row int8 (quantize_int8 of the transposed table); a
        vocab-split table quantizes its own rows and stays split."""
        with torch.no_grad():
            q, scale = quantize_int8(self.embedding.t())
            out = Int8TiedEmbedding(q.t().contiguous(), scale)
            out.tp = self.tp
            return out


def masked_rows(table_rows, tokens: torch.Tensor, n: int, rank: int):
    """(rows, inside): `table_rows(i)` at each token's index among this
    rank's `n` vocab rows (row 0 where the token is another rank's), and
    whether it is this rank's."""
    local = tokens.long() - rank * n
    inside = (local >= 0) & (local < n)
    return table_rows(local.clamp(0, n - 1)), inside


class Int8TiedEmbedding(nn.Module):
    """The int8 serving form of TiedEmbedding (the JAX package's
    ``{embedding_q, scale}`` tree): buffers ``embedding_q`` int8 [V, D] and
    ``scale`` f32 [V]. A lookup dequantizes its rows in f32, then casts;
    ``attend`` streams the row-major table through K11 and returns f32.

    Vocab-parallel as TiedEmbedding (``tp`` set): a rank holds rows
    [r V / tp, (r + 1) V / tp) and their scales; a lookup dequantizes its
    rows where the token falls in them, zeros elsewhere, summed over the
    group; the logits are K11 over its rows, joined over the group."""

    tp = None

    def __init__(self, embedding_q: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("embedding_q", embedding_q)
        self.register_buffer("scale", scale)

    def _rows(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return (self.embedding_q[t].float() * self.scale[t][..., None]).to(dtype)

    def forward(self, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.tp is None:
            return self._rows(tokens.long(), dtype)
        rows, inside = masked_rows(lambda t: self._rows(t, dtype), tokens,
                                   self.embedding_q.shape[0], self.tp.rank)
        return self.tp.reduce(rows * inside[..., None].to(dtype))

    def attend(self, x: torch.Tensor, dtype: torch.dtype, kernels: bool = True) -> torch.Tensor:
        """f32 logits [..., V] (`dtype` is the bf16 table's, unused here)."""
        out = int8_tied_logits(x.reshape(-1, x.shape[-1]), self.embedding_q, self.scale, kernels)
        if self.tp is not None:
            out = self.tp.gather(out, -1)
        return out.reshape(*x.shape[:-1], out.shape[-1])


class WhisperEncoder(nn.Module):
    def __init__(self, cfg: WhisperConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.conv1 = Conv(cfg.num_mels, cfg.d_model, 3, gen)
        self.conv2 = Conv(cfg.d_model, cfg.d_model, 3, gen)
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg.d_model, cfg.num_heads, cfg.mlp_dim, gen, "erf", cfg.dropout,
                             _adapter(cfg), cfg.use_flash_attention, cfg.flash_train_min_q)
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
        remat = cfg.remat and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x = checkpoint(block, x, None, kernels, use_reentrant=False,
                               preserve_rng_state=False)
            else:
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
                             _adapter(cfg), cfg.use_flash_attention, cfg.flash_train_min_q,
                             cross_attention=True)
            for _ in range(cfg.decoder_layers)
        )
        self.ln = LayerNorm(cfg.d_model)

    def forward(self, tokens: torch.Tensor, enc: torch.Tensor,
                enc_lengths: Optional[torch.Tensor] = None, kernels: bool = True):
        """Teacher-forced: tokens [B, S], enc [B, T, d] -> logits [B, S, V]."""
        dt = DTYPES[self.cfg.dtype]
        x = self.embed_tokens(tokens, dt) + self.embed_positions[:tokens.shape[1]].to(dt)[None]
        return teacher_forced(self.blocks, self.ln, self.embed_tokens, x, enc, enc_lengths,
                              kernels, dt)

    def init_cache(self, batch: int, enc: torch.Tensor, max_len: Optional[int] = None,
                   layout: Optional[str] = None, beams: int = 1) -> Dict:
        """``decoder_caches`` over max_target_positions, capped at max_len."""
        t_cache = self.cfg.max_target_positions
        if max_len is not None:
            t_cache = min(max_len, t_cache)
        return decoder_caches(self.blocks, self.cfg, batch, enc, t_cache, layout,
                              is_quantized(self), beams)

    def decode_step(self, token: torch.Tensor, pos, enc: torch.Tensor, caches: Dict,
                    enc_lengths: Optional[torch.Tensor] = None, kernels: bool = True):
        """``decoder_step`` with the learned position embedding."""
        dt = DTYPES[self.cfg.dtype]
        return decoder_step(self.blocks, self.ln, self.embed_tokens,
                            lambda p: self.embed_positions[p].to(dt), token, pos, enc, caches,
                            enc_lengths, kernels, dt)


def teacher_forced(blocks, ln, embed, x: torch.Tensor, enc: torch.Tensor,
                   enc_lengths: Optional[torch.Tensor], kernels: bool, dt: torch.dtype):
    """A decoder's teacher-forced pass over x [B, S, d] (tokens embedded,
    positions added): causal self-attention, cross-attention over enc
    [B, T, d] (its first enc_lengths frames when given), final LN, tied
    logits [B, S, V] in `dt`."""
    S = x.shape[1]
    causal = torch.tril(torch.ones(S, S, dtype=torch.bool, device=x.device))[None, None]
    enc_mask = length_mask(enc_lengths, enc.shape[1]) if enc_lengths is not None else None
    for block in blocks:
        x = block(x, None, kernels, mask=causal, enc=enc, enc_mask=enc_mask,
                  enc_kv_lengths=enc_lengths)
    return embed.attend(ln(x), dt, kernels)


def decoder_caches(blocks, cfg, batch: int, enc: torch.Tensor, t_cache: int,
                   layout: Optional[str] = None, int8: bool = False, beams: int = 1) -> Dict:
    """Per-block caches of a decoder whose blocks have cross-attention
    (`cfg` gives num_heads, d_model and dtype): zeroed self K/V over
    `t_cache` positions and the cross K/V projected once from the encoder
    output. Head-major [B, H, T, dh] (horizons padded to a multiple of 128,
    so K9 reads them as they are) on a CUDA device or at batch >=
    HEAD_MAJOR_MIN_BATCH; packed [B, T, d] otherwise, or when `layout`
    says so ("packed" | "head_major"). An int8 decoder (`int8`) stores its
    cross caches int8 head-major at every batch, with f32 per-position
    scales ``k_scale``/``v_scale`` (0 in the padding), and its self caches
    so where the JAX package does: at batch >= HEAD_MAJOR_MIN_BATCH, or
    with layout="head_major".

    With ``beams`` = K > 1 the caches serve batch * K rows, row b * K + k
    for beam k of utterance b, and every decision above is made at that
    batch: the cross K/V are projected once from enc [batch, T, d] and
    repeated K times, bit for bit init_cache over enc repeated K times.

    An Att-adapted decoder (``cfg.adapter.kind == "att"``) also gets a
    block's ``slots``: zeroed packed K/V caches [rows, T, heads * key_dim]
    in the compute dtype for its ``post_attn`` and ``post_mlp`` slots, over
    the self caches' horizon (128-rounded when head-major), which the
    decode step's key mask spans."""
    dt = DTYPES[cfg.dtype]
    rows = batch * beams
    # a tensor-parallel rank's heads (parallel/tp.py), or all of them
    H, dh = blocks[0].cross_attn.num_heads, blocks[0].cross_attn.head_dim
    if layout is None:
        jax_head_major = rows >= HEAD_MAJOR_MIN_BATCH
        head_major = _on_card(enc) or jax_head_major
    elif layout in ("packed", "head_major"):
        head_major = jax_head_major = layout == "head_major"
    else:
        raise ValueError(f"unknown cache layout {layout!r}")
    int8_self = int8 and jax_head_major
    caches = {}
    for i, block in enumerate(blocks):
        cross = block.precompute_cross(enc)
        if head_major or int8:
            t_enc = cross["k"].shape[1]
            cross = {n: a.reshape(batch, t_enc, H, dh).transpose(1, 2) for n, a in cross.items()}
            if int8:
                (kq, ks), (vq, vs) = quantize_kv(cross["k"]), quantize_kv(cross["v"])
                cross = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
            cross = {n: pad_time_to_tk(a, 2).contiguous() for n, a in cross.items()}
        if beams > 1:
            cross = {n: a.repeat_interleave(beams, 0) for n, a in cross.items()}
        if head_major:
            shape = (rows, H, round_tk(t_cache), dh)
        else:
            shape = (rows, t_cache, H * dh)
        dev = enc.device
        if int8_self:  # zero scales: unwritten rows read as 0, as the bf16 zeros
            self_cache = {}
            for n in ("k", "v"):
                self_cache[n] = torch.zeros(shape, dtype=torch.int8, device=dev)
                self_cache[f"{n}_scale"] = torch.zeros(shape[:-1], device=dev)
        else:
            self_cache = {n: torch.zeros(shape, dtype=dt, device=dev) for n in ("k", "v")}
        entry = {"self": self_cache, "cross": cross}
        if cfg.adapter.kind == "att":
            t_self = shape[-2]
            slot_shape = (rows, t_self, cfg.adapter.att_num_heads * cfg.adapter.att_key_dim)
            entry["slots"] = {s: {n: torch.zeros(slot_shape, dtype=dt, device=dev)
                                  for n in ("k", "v")} for s in ("post_attn", "post_mlp")}
        caches[f"block_{i}"] = entry
    return caches


def decoder_step(blocks, ln, embed, position_rows, token: torch.Tensor, pos, enc: torch.Tensor,
                 caches: Dict, enc_lengths: Optional[torch.Tensor], kernels: bool,
                 dt: torch.dtype):
    """One cached step: token [B, 1] -> (logits [B, V], caches), the caches
    updated in place. ``position_rows(p)`` gives the position embedding in
    `dt` of an int p ([d]) or of a [B] index tensor ([B, d]). `pos` is an
    int (every row in lockstep, the offline loops) or a tensor on the
    model's device, [B] or 0-dim: each row at its own position (the serving
    engine's lanes), so the position embedding, the key mask, the kernels'
    lengths and the self-cache row writes are per row. With a tensor `pos`
    the step neither copies to the device nor reads back from it, so it can
    be captured in a CUDA graph. The cross caches stand for `enc`, which is
    read for its length only."""
    B = token.shape[0]
    t_cache = caches["block_0"]["self"]["k"].shape[-2]
    keys = torch.arange(t_cache, device=token.device)
    if torch.is_tensor(pos):
        pos = pos.reshape(-1).expand(B)
        x = embed(token, dt) + position_rows(pos)[:, None]
        kmask = (keys[None, :] <= pos[:, None])[:, None, None, :]
        lens = (pos + 1).to(torch.int32)
    else:
        x = embed(token, dt) + position_rows(pos)[None, None]
        kmask = (keys <= pos)[None, None, None, :]
        lens = torch.full((B,), pos + 1, dtype=torch.int32, device=x.device)
    enc_mask = length_mask(enc_lengths, enc.shape[1]) if enc_lengths is not None else None
    for i, block in enumerate(blocks):
        c = caches[f"block_{i}"]
        x, c["self"], c["cross"], slots = block(
            x, lens, kernels, mask=kmask, enc=enc, enc_mask=enc_mask,
            self_cache=c["self"], cross_cache=c["cross"], cache_index=pos,
            enc_kv_lengths=enc_lengths, slot_caches=c.get("slots"))
        if slots is not None:
            c["slots"] = slots
    return embed.attend(ln(x), dt, kernels)[:, 0], caches


class WhisperModel(nn.Module):
    """forward(mel, tokens) -> teacher-forced logits [B, S, V]; encode /
    decode / decode_step / init_cache as in the JAX module."""

    def __init__(self, cfg: WhisperConfig, device="cpu", seed: int = 0):
        super().__init__()
        if cfg.dtype not in DTYPES:
            raise ValueError(f"unknown compute dtype {cfg.dtype!r}")
        self.cfg = cfg
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        with device:  # parameters are made and initialised where they live
            self.encoder = WhisperEncoder(cfg, gen)
            self.decoder = WhisperDecoder(cfg, gen)
        self._dropouts = [m for m in self.modules() if isinstance(m, Dropout)]
        for site, m in enumerate(self._dropouts):
            m.site = site

    def forward(self, mel, tokens, enc_lengths=None, kernels: bool = True,
                dropout_seed: Optional[int] = None):  # needed in training when dropout > 0
        arm_dropout(self._dropouts, dropout_seed)
        return self.decoder(tokens, self.encoder(mel, kernels), enc_lengths, kernels)

    def encode(self, mel, kernels: bool = True):
        return self.encoder(mel, kernels)

    def decode(self, tokens, enc, enc_lengths=None, kernels: bool = True):
        return self.decoder(tokens, enc, enc_lengths, kernels)

    def decode_step(self, token, pos, enc, caches, enc_lengths=None, kernels: bool = True):
        return self.decoder.decode_step(token, pos, enc, caches, enc_lengths, kernels)

    def init_cache(self, batch: int, enc, max_len: Optional[int] = None,
                   layout: Optional[str] = None, beams: int = 1):
        return self.decoder.init_cache(batch, enc, max_len, layout, beams)
