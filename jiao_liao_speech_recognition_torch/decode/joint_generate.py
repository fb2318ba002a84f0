"""Decoding for the joint CTC/attention model, the PyTorch twin of the JAX
package's ``decode/joint_generate.py``:

* greedy - the shared AR loop (``whisper_generate.greedy_from_enc``) over
  the encoder output, sos = eos = the CTC blank (0), captured on a card
  unless graph=False;
* beam   - the shared beam (``whisper_generate.beam_from_enc``) returns all
  K hypotheses; each is rescored with the CTC branch's exact sequence
  log-probability (``ops/ctc_loss.py`` over the CTC log-probs already
  computed, all B * K in one batched pass, no second encoder pass), and the
  winner maximises ctc_weight * logP_ctc + (1 - ctc_weight) * logP_att,
  both divided by max(length, 1) ** length_penalty.
"""

from __future__ import annotations

from typing import Optional

import torch

from .whisper_generate import beam_from_enc, best_beam, greedy_from_enc, length_norm


@torch.inference_mode()
def joint_greedy(model, feats: torch.Tensor, feat_lengths: Optional[torch.Tensor] = None,
                 max_len: int = 64, bos_eos_id: int = 0, kernels: bool = True,
                 graph: bool = True):
    """feats [B, mels, T] -> (tokens [B, max_len - 1], lengths [B])."""
    enc, enc_lengths = model.encode(feats, feat_lengths, kernels)
    return greedy_from_enc(model, enc, enc_lengths, max_len, (bos_eos_id,), bos_eos_id,
                           kernels=kernels, graph=graph)


@torch.inference_mode()
def joint_beam(model, feats: torch.Tensor, feat_lengths: Optional[torch.Tensor] = None,
               beam_size: int = 4, max_len: int = 64, length_penalty: float = 1.0,
               ctc_weight: Optional[float] = None, bos_eos_id: int = 0, kernels: bool = True,
               graph: bool = True):
    """Attention beam with CTC rescoring -> (tokens [B, max_len - 1],
    lengths [B]). ctc_weight=None takes model.cfg.ctc_weight; 0 drops the
    CTC term (the attention beam alone)."""
    if ctc_weight is None:
        ctc_weight = model.cfg.ctc_weight
    enc, enc_lengths = model.encode(feats, feat_lengths, kernels)
    gen, lengths, att = beam_from_enc(model, enc, enc_lengths, beam_size, max_len,
                                      (bos_eos_id,), bos_eos_id, kernels=kernels, graph=graph)
    norm = length_norm(lengths, length_penalty)
    ranking = att / norm
    if ctc_weight > 0.0:
        nll = ctc_rescore(model, enc, enc_lengths, gen, lengths, bos_eos_id, kernels=kernels)
        ranking = ctc_weight * (-nll / norm) + (1.0 - ctc_weight) * ranking
    return best_beam(gen, lengths, ranking)


def ctc_rescore(model, enc: torch.Tensor, enc_lengths: torch.Tensor, gen: torch.Tensor,
                lengths: torch.Tensor, blank_id: int = 0, kernels: bool = True) -> torch.Tensor:
    """-log P_ctc of every hypothesis [B, K] (f32) in one batched pass:
    the CTC log-probs of enc, repeated K times, against the B * K label
    rows (jl_ctc_loss's forward on the card; kernels=False its plain
    version)."""
    from ..ops.ctc_loss import ctc_loss

    B, K, L = gen.shape
    lp = model.ctc_log_probs(enc)
    nll = ctc_loss(lp.repeat_interleave(K, 0), enc_lengths.repeat_interleave(K, 0),
                   gen.reshape(B * K, L), lengths.reshape(B * K), blank_id=blank_id,
                   kernels=kernels)
    return nll.reshape(B, K)
