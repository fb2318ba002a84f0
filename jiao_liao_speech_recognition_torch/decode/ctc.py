"""Greedy CTC decoding, the PyTorch twin of the JAX package's
``decode/ctc.py`` greedy half: argmax per frame -> collapse repeats -> drop
blanks. The collapse runs on the device (cumsum + scatter); only the final
id -> text lookup needs the host.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def ctc_greedy_collapse(
    tokens: torch.Tensor,  # [B, T] argmax ids
    lengths: torch.Tensor,  # [B] valid frames
    blank_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (ids [B, T] left-packed, zero-padded; out_lengths [B])."""
    B, T = tokens.shape
    pos = torch.arange(T, device=tokens.device)[None, :]
    valid = pos < lengths.to(tokens.device)[:, None]
    prev = torch.cat([torch.full_like(tokens[:, :1], -1), tokens[:, :-1]], dim=1)
    keep = valid & (tokens != blank_id) & (tokens != prev)
    idx = torch.cumsum(keep, dim=1) - 1
    out_lengths = keep.sum(dim=1).to(torch.int32)
    scatter_idx = torch.where(keep, idx, torch.full_like(idx, T))  # dropped -> col T
    out = torch.zeros(B, T + 1, dtype=tokens.dtype, device=tokens.device)
    out.scatter_(1, scatter_idx, tokens)
    return out[:, :T], out_lengths


def ctc_greedy_decode(
    log_probs: torch.Tensor,  # [B, T, V]
    lengths: torch.Tensor,  # [B]
    blank_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy CTC decode -> (packed ids [B, T], lengths [B])."""
    tokens = torch.argmax(log_probs, dim=-1).to(torch.int32)
    return ctc_greedy_collapse(tokens, lengths, blank_id)


def ctc_collapse_with_times(
    frame_ids: np.ndarray,  # [T] per-frame argmax ids (host)
    length: int,
    blank_id: int = 0,
) -> List[Tuple[int, int, int]]:
    """Host-side greedy collapse keeping the frame alignment:
    [(token_id, start_frame, end_frame_exclusive)], the same emission rule
    as ctc_greedy_collapse; a token's span is its run of equal frames."""
    out: List[Tuple[int, int, int]] = []
    prev = -1
    for t in range(int(length)):
        tid = int(frame_ids[t])
        if tid != blank_id and tid != prev:
            out.append((tid, t, t + 1))
        elif tid != blank_id and out and out[-1][0] == tid:
            out[-1] = (tid, out[-1][1], t + 1)
        prev = tid
    return out


def ids_to_texts(ids: np.ndarray, lengths: np.ndarray, tokenizer) -> List[str]:
    """Host-side final lookup: packed id rows -> strings."""
    return [
        tokenizer.decode([int(t) for t in row[: int(n)]])
        for row, n in zip(np.asarray(ids), np.asarray(lengths))
    ]
