"""CTC loss in the JAX package's signature and conventions
(``ops/ctc_loss.py``): [B, T, V] log-probs, blank 0, per-example negative
log likelihood [B].

The JAX loss is a ``lax.scan`` alpha recursion, not a Pallas kernel, so the
port calls ``F.ctc_loss(reduction="none")``. One convention differs and is
kept: the JAX recursion floors log space at -1e30, so a pair whose label
needs more frames than it has (labels plus one blank between each repeated
pair) gets NLL 1e30 where ``F.ctc_loss`` says inf. Such pairs return 1e30
here with zero gradient (the JAX gradient of that floor is not meaningful).

``F.ctc_loss`` differentiates as if a log_softmax were folded into it: its
gradient is exp(log_probs) - posterior on each valid frame. The JAX function
is differentiated with respect to the log-probs themselves (-posterior), so
a zero-valued term removes the exp(log_probs) part. Through the model's
log_softmax both give the same gradient on the logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

INFEASIBLE_NLL = 1e30  # the JAX recursion's floor, negated


def ctc_loss(log_probs: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """-> per-example NLL [B] (float32)."""
    B, T, _ = log_probs.shape
    labels = labels.long()
    logit_lengths = logit_lengths.long().clamp(0, T)
    label_lengths = label_lengths.long()
    S = labels.shape[1]
    lp = log_probs.float()
    nll = F.ctc_loss(
        lp.transpose(0, 1), labels, logit_lengths, label_lengths,
        blank=blank_id, reduction="none", zero_infinity=True,
    )
    # frames needed: every label, plus a blank between equal neighbours
    valid = torch.arange(S, device=labels.device)[None, :] < label_lengths[:, None]
    repeats = ((labels[:, 1:] == labels[:, :-1]) & valid[:, 1:]).sum(1) if S > 1 else 0
    infeasible = logit_lengths < label_lengths + repeats
    if lp.requires_grad:  # value + 0, gradient - exp(lp) on feasible valid frames
        frames = torch.arange(T, device=lp.device)[None, :] < logit_lengths[:, None]
        mass = (lp.exp().sum(-1) * (frames & ~infeasible[:, None])).sum(-1)
        nll = nll - (mass - mass.detach())
    return torch.where(infeasible, torch.full_like(nll, INFEASIBLE_NLL), nll)



def ctc_loss_mean(log_probs: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """The batch mean of each NLL over its label length (at least 1): the
    JAX function, ``F.ctc_loss(reduction="mean")``'s normalisation."""
    nll = ctc_loss(log_probs, logit_lengths, labels, label_lengths, blank_id)
    return (nll / label_lengths.to(nll.device).clamp_min(1).float()).mean()
