"""CTC-draft speculative greedy decoding for the joint CTC/attention model,
the PyTorch twin of the JAX package's ``decode/speculative.py``.

One encoder pass gives the CTC branch's greedy collapse (K4 on the card)
as a draft for the attention decoder: tokens[0] = sos, tokens[1:] = the
draft, eos-padded. Each pass runs one teacher-forced decoder forward over
all positions (``decode_teacher``: K3 or K7-mlp for its MLPs at 64 or more
positions, K6 for its cross-attention), takes pred = argmax of its logits,
finds each row's first mismatch m at or past its verified prefix, writes
pred[m] there and accepts up to m + 1. Rows stop at a verified eos or the
horizon; the loop stops when every row has (the host reads that after
every pass, as the JAX while_loop's cond tests it). A position's logits
depend only on the tokens before it (the causal mask), so the result is
the greedy decode under the teacher-forced scoring path, whatever the
draft: a perfect draft verifies in one pass, an empty one takes one pass
a token.

The state (tokens, accepted counts, done flags, a pass counter) lives in
device tensors written in place, so on a card the pass is a CUDA graph
(utils/graphs.py): the first pass runs eagerly on the side stream as the
warm-up (the JAX loop always runs it), and when another pass is needed one
pass is captured and replayed one pass a replay, with the host read after
each. The counter rises only on a pass the JAX cond lets run, and is read
once at the end.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.tp import model_tp
from ..utils import graphs
from .ctc import ctc_greedy_collapse
from .whisper_generate import STEPS, _run_loop


@torch.inference_mode()
def joint_spec_greedy(model, feats: torch.Tensor, feat_lengths: Optional[torch.Tensor] = None,
                      max_len: int = 64, bos_eos_id: int = 0, return_passes: bool = False,
                      kernels: bool = True, graph: bool = True):
    """-> (tokens [B, max_len - 1], lengths [B][, verification passes]),
    the conventions of joint_generate.joint_greedy; the passes captured on
    a card unless graph=False."""
    enc, enc_lengths = model.encode(feats, feat_lengths, kernels)
    draft, draft_lens = ctc_greedy_collapse(model.ctc_argmax_ids(enc, kernels), enc_lengths,
                                            bos_eos_id)
    return spec_greedy_from_enc(model, enc, enc_lengths, draft, draft_lens, max_len=max_len,
                                bos_eos_id=bos_eos_id, return_passes=return_passes,
                                kernels=kernels, graph=graph)


@torch.inference_mode()
def spec_greedy_from_enc(model, enc: torch.Tensor, enc_lengths: Optional[torch.Tensor],
                         draft: torch.Tensor, draft_lens: torch.Tensor, *, max_len: int = 64,
                         bos_eos_id: int = 0, return_passes: bool = False,
                         kernels: bool = True, graph: bool = True):
    """Verify any draft [B, Ld] (no eos inside; draft_lens [B]) against the
    attention decoder's greedy path."""
    B, dev = enc.shape[0], enc.device
    L = int(max_len)
    G = L - 1  # generated positions: gen = tokens[:, 1:]
    eos = bos_eos_id
    capture = graphs.capturing(dev, graph, model, "spec_greedy_from_enc")
    tokens = torch.full((B, L), eos, dtype=torch.long, device=dev)
    k = min(draft.shape[1], G)
    if k > 0:
        dmask = (torch.arange(k, device=dev)[None, :]
                 < torch.clamp(draft_lens.to(dev), max=k)[:, None])
        tokens[:, 1:1 + k] = torch.where(dmask, draft[:, :k].to(dev).long(), eos)
    pos = torch.arange(G, device=dev)[None, :]
    n_acc = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    passes = torch.zeros((), dtype=torch.long, device=dev)
    tp = model_tp(model)

    def verify(_p: int) -> None:
        """One pass, in place; a pass the JAX cond would not run changes nothing."""
        passes.add_((~done.all() & (passes < G)).long())
        logits = model.decode_teacher(tokens, enc, enc_lengths, kernels)
        prop = torch.argmax(logits, dim=-1)[:, :G]  # prop[:, g] follows tokens[:, :g + 1]
        guess = tokens[:, 1:]
        mism = (guess != prop) & (pos >= n_acc[:, None])
        m = torch.where(mism.any(dim=1), torch.argmax(mism.to(torch.int32), dim=1),
                        torch.full_like(n_acc, G))
        new_gen = torch.where(pos == m[:, None], prop, guess)
        new_gen = torch.where(done[:, None], guess, new_gen)
        n_acc.copy_(torch.where(done, n_acc, torch.clamp(m + 1, max=G)))
        verified_eos = ((new_gen == eos) & (pos < n_acc[:, None])).any(dim=1)
        done.logical_or_(verified_eos | (n_acc >= G))
        tokens[:, 1:] = new_gen

    def stop() -> bool:
        flag = bool(done.all())
        return tp.agree(flag) if tp is not None and tp.size > 1 else flag

    _run_loop(verify, G, min(1, G), stop, capture, per_replay=1)
    n_passes = int(passes)
    STEPS.passes += n_passes
    gen = tokens[:, 1:]
    is_eot = gen == eos
    first = torch.argmax(is_eot.to(torch.int32), dim=1)
    lengths = torch.where(is_eot.any(dim=1), first, torch.full_like(first, G))
    # stale draft tokens past a verified eos are blanked: the padded array
    # is canonical, not only the length-sliced text
    gen = torch.where(pos >= lengths[:, None], eos, gen)
    return (gen, lengths, n_passes) if return_passes else (gen, lengths)
