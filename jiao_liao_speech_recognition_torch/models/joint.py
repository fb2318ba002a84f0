"""Joint CTC/attention transformer, the PyTorch twin of the JAX package's
``models/joint.py`` (SpeechBrain's TransformerASR recipe shape).

One conv-subsampled encoder feeds two heads: a CTC head (greedy ids by K4
on the card) and an attention decoder of cross-attention blocks with a
tied output embedding. The CTC blank (id 0) doubles as the decoder's sos
and eos, so both heads share one vocabulary.

Module names follow the flax tree (``subsample``, ``enc_blocks`` for
``enc_block_i``, ``enc_ln``, ``ctc_head``, ``embed_tokens``, ``dec_blocks``
for ``dec_block_i``, ``dec_ln``), so ``models/convert.py`` is a rename. The
encoder is the CTC model's trunk (``ctc_model.encoder_trunk``); the
decoder shares Whisper's teacher-forced pass, caches and cached step
(``whisper.teacher_forced``, ``decoder_caches``, ``decoder_step``) with
sinusoidal positions in place of learned ones. The tied logits are in the
compute dtype: flax's ``Embed.attend`` promotes both operands to bf16 in a
bf16 model, whatever the input's dtype.

On the card an encoder block serves through K2 and K3 (K7 with WF
inserts), a teacher-forced pass of 64 or more positions runs its MLPs
through K3 (K7-mlp), and a decode step runs K9 for the self- and the
cross-attention of every block over head-major caches.

Training (``model.train()``, the joint loss of train/engine.py): every
block takes the module path; dropout masks are seeded per forward by
``dropout_seed``; the encoder's self-attention runs flash (K6 forward, K8
backward) in bf16 at T' >= ``flash_train_min_q``, and the decoder's
teacher-forced pass (S below that) the einsum formulation, as the JAX
gate puts them. ``cfg.remat`` recomputes each encoder block in the
backward (the JAX module remats the encoder blocks only).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..utils.config import JointModelConfig
from .ctc_model import DTYPES, CTCHead, ConvSubsampler, encoder_trunk
from .layers import Dropout, LayerNorm, TransformerBlock, arm_dropout, sinusoidal_positions
from .whisper import TiedEmbedding, decoder_caches, decoder_step, teacher_forced


class JointCTCAttentionModel(nn.Module):
    """forward(features, lengths, tokens) -> (CTC log-probs [B, T', V] f32,
    valid frames [B], teacher-forced logits [B, S, V] or None); encode /
    ctc_log_probs / ctc_argmax_ids / frame_ids / decode_teacher /
    init_cache / decode_step as the JAX module's methods."""

    def __init__(self, cfg: JointModelConfig, device="cpu", seed: int = 0):
        super().__init__()
        if cfg.position_mode not in ("sinusoidal", "none"):
            raise ValueError(f"unknown position_mode {cfg.position_mode!r}")
        if cfg.dtype not in DTYPES:
            raise ValueError(f"unknown compute dtype {cfg.dtype!r}")
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        d, H = cfg.d_model, cfg.num_heads
        adapter = cfg.adapter if cfg.adapter.kind != "none" else None
        self.subsample = ConvSubsampler(cfg.num_mels, d, cfg.conv_channels,
                                        cfg.subsample_factor, gen)
        self.enc_blocks = nn.ModuleList(
            TransformerBlock(d, H, cfg.mlp_dim, gen, cfg.gelu_form, cfg.dropout, adapter,
                             cfg.use_flash_attention, cfg.flash_train_min_q)
            for _ in range(cfg.num_layers))
        self.enc_ln = LayerNorm(d)
        self.ctc_head = CTCHead(d, cfg.vocab_size, gen)
        self.embed_tokens = TiedEmbedding(cfg.vocab_size, d, gen)
        self.dec_blocks = nn.ModuleList(
            TransformerBlock(d, H, cfg.mlp_dim, gen, cfg.gelu_form, cfg.dropout, adapter,
                             cfg.use_flash_attention, cfg.flash_train_min_q, cross_attention=True)
            for _ in range(cfg.decoder_layers))
        self.dec_ln = LayerNorm(d)
        self._dropouts = [m for m in self.modules() if isinstance(m, Dropout)]
        for site, m in enumerate(self._dropouts):
            m.site = site
        self.to(device)

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.dtype]

    # --- encoder and CTC branch ---------------------------------------------

    def encode(self, features: torch.Tensor, feature_lengths: Optional[torch.Tensor] = None,
               kernels: bool = True):
        """features [B, num_mels, T] -> (enc [B, T', d] in the compute
        dtype, valid frames [B] int32)."""
        remat = self.cfg.remat and self.training and torch.is_grad_enabled()
        x, out_lengths = encoder_trunk(self.cfg, self.subsample, self.enc_blocks, features,
                                       feature_lengths, kernels, remat=remat)
        return self.enc_ln(x), out_lengths

    def ctc_log_probs(self, enc: torch.Tensor) -> torch.Tensor:
        return torch.log_softmax(self.ctc_head(enc), dim=-1)

    def ctc_argmax_ids(self, enc: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        """Per-frame greedy ids [B, T'] int32 (K4 for bf16 on the card)."""
        return self.ctc_head.argmax_ids(enc, kernels)

    def frame_ids(self, features: torch.Tensor, feature_lengths: Optional[torch.Tensor] = None,
                  kernels: bool = True):
        """-> (per-frame CTC greedy ids [B, T'] int32, valid frames [B]),
        as CTCEncoderModel.frame_ids."""
        enc, lens = self.encode(features, feature_lengths, kernels)
        return self.ctc_argmax_ids(enc, kernels), lens

    # --- attention branch ---------------------------------------------------

    def _positions(self, length: int, device) -> torch.Tensor:
        return sinusoidal_positions(length, self.cfg.d_model, self.dtype, str(device))

    def decode_teacher(self, tokens: torch.Tensor, enc: torch.Tensor,
                       enc_lengths: Optional[torch.Tensor] = None, kernels: bool = True):
        """tokens [B, S] -> logits [B, S, V] in the compute dtype."""
        S = tokens.shape[1]
        if S > self.cfg.max_target_positions:
            raise ValueError(f"{S} target positions > max_target_positions="
                             f"{self.cfg.max_target_positions}")
        dt = self.dtype
        x = self.embed_tokens(tokens, dt) + self._positions(S, tokens.device)[None]
        return teacher_forced(self.dec_blocks, self.dec_ln, self.embed_tokens, x, enc,
                              enc_lengths, kernels, dt)

    def forward(self, features: torch.Tensor, feature_lengths: Optional[torch.Tensor] = None,
                tokens: Optional[torch.Tensor] = None, kernels: bool = True,
                dropout_seed: Optional[int] = None):  # needed in training when dropout > 0
        arm_dropout(self._dropouts, dropout_seed)
        enc, out_lengths = self.encode(features, feature_lengths, kernels)
        dec_logits = None
        if tokens is not None:
            dec_logits = self.decode_teacher(tokens, enc, out_lengths, kernels)
        return self.ctc_log_probs(enc), out_lengths, dec_logits

    def init_cache(self, batch: int, enc: torch.Tensor, max_len: Optional[int] = None,
                   layout: Optional[str] = None, beams: int = 1) -> Dict:
        """Zeroed self caches over min(max_len, max_target_positions)
        positions, the cross K/V projected once from enc, and an Att
        adapter's slot caches (``whisper.decoder_caches``: the same
        layouts)."""
        t_cache = self.cfg.max_target_positions
        if max_len is not None:
            t_cache = min(max_len, t_cache)
        return decoder_caches(self.dec_blocks, self.cfg, batch, enc, t_cache, layout,
                              beams=beams)

    def decode_step(self, token: torch.Tensor, pos, enc: torch.Tensor, caches: Dict,
                    enc_lengths: Optional[torch.Tensor] = None, kernels: bool = True):
        """``whisper.decoder_step`` with the sinusoidal positions."""
        dt = self.dtype
        table = self._positions(self.cfg.max_target_positions, token.device)
        return decoder_step(self.dec_blocks, self.dec_ln, self.embed_tokens, lambda p: table[p],
                            token, pos, enc, caches, enc_lengths, kernels, dt)
