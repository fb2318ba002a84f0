"""Cross-attention forced alignment for the Whisper family: per-token
timestamps, the PyTorch twin of the JAX package's ``decode/align.py``.

One teacher-forced decoder pass over the prompt and the generated ids, with
forward hooks on each block's cross-attention ``q_proj`` and ``k_proj``
(the JAX package captures the same module outputs with flax's
``capture_intermediates``; the pass itself runs the serving kernels). The
attention probabilities are recomputed in f32 from those q and k
(softmax(q k^T / sqrt(dh)), the module's own math), averaged over the
``alignment_heads`` of the config, or over every head of every layer when
it names none, and a monotonic DTW over each utterance's [tokens x encoder
frames] matrix gives contiguous per-token frame spans. One encoder frame is
2 mel hops (20 ms at 16 kHz).

On a tensor-parallel model (parallel/tp.py) a rank's projections hold its
heads' columns: the hooks join them over the group, so every rank reduces
the whole layer's q and k as one card does and takes the same spans.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.numerics import full_f32
from ..parallel.tp import model_tp


def _decoder_cross_qk(model, mel: torch.Tensor, tokens, layers=None) -> Dict[int, tuple]:
    """Teacher-forced pass -> {block index: (q [B, S, d], k [B, T, d])}, the
    cross-attention projections of the blocks in `layers` (all when None).
    `tokens` is the whole [B, S] sequence (prompt + generated), `mel` the
    [B, mels, frames] features the ids were decoded from."""
    captured: Dict[int, dict] = {}
    hooks = []
    tp = model_tp(model)

    def keep(i, name):
        def hook(module, _args, out):
            if module.tp is not None and module.tp_mode == "column":
                out = tp.gather(out, -1)  # this rank's heads -> every head
            captured.setdefault(i, {})[name] = out
        return hook

    for i, block in enumerate(model.decoder.blocks):
        if layers is None or i in layers:
            hooks.append(block.cross_attn.q_proj.register_forward_hook(keep(i, "q")))
            hooks.append(block.cross_attn.k_proj.register_forward_hook(keep(i, "k")))
    try:
        with torch.no_grad():
            enc = model.encode(mel)
            toks = torch.as_tensor(np.asarray(tokens), dtype=torch.long).to(enc.device)
            model.decode(toks, enc)
    finally:
        for h in hooks:
            h.remove()
    return {i: (c["q"], c["k"]) for i, c in captured.items()}


def reduce_cross_attention(captured: Dict[int, tuple], num_heads: int,
                           by_layer: Dict[int, List[int]]) -> torch.Tensor:
    """Per-layer f32 probabilities softmax(q k^T / sqrt(dh)), the selected
    heads of each layer summed (every head when `by_layer` is empty), the
    sum divided by the heads taken -> [B, S, T] f32 on q's device."""
    acc, n = None, 0
    for i, (q, k) in sorted(captured.items()):
        heads = by_layer.get(i) if by_layer else None
        B, S, d = q.shape
        T = k.shape[1]
        dh = d // num_heads
        qh = q.reshape(B, S, num_heads, dh).float()
        kh = k.reshape(B, T, num_heads, dh).float()
        with full_f32():
            s = torch.einsum("bshd,bthd->bhst", qh, kh) / math.sqrt(dh)
        p = torch.softmax(s, dim=-1)
        if heads:
            p = p[:, heads]
        acc = p.sum(dim=1) if acc is None else acc + p.sum(dim=1)
        n += p.shape[1]
    return acc / n


def cross_attention_matrix(model, mel: torch.Tensor, tokens) -> np.ndarray:
    """[B, S, T] f32: teacher-forced cross-attention probabilities over the
    whole encoder horizon, averaged over ``cfg.alignment_heads`` ((layer,
    head) pairs, as an imported checkpoint's generation config gives them)
    or over every head of every layer when it is empty."""
    cfg = model.cfg
    by_layer: Dict[int, List[int]] = {}
    for layer, head in cfg.alignment_heads:
        by_layer.setdefault(int(layer), []).append(int(head))
    by_layer = {layer: sorted(heads) for layer, heads in by_layer.items()}
    captured = _decoder_cross_qk(model, mel, tokens, set(by_layer) if by_layer else None)
    if not captured:
        raise ValueError("no cross-attention captured: an empty decoder, or alignment_heads "
                         "naming layers outside the model")
    with torch.no_grad():
        return reduce_cross_attention(captured, cfg.num_heads, by_layer).cpu().numpy()


def dtw_spans(attn: np.ndarray) -> List[Tuple[int, int]]:
    """Monotonic DTW over one utterance's [S_tokens, T_frames] attention
    matrix. Moves are (token+1, frame+1) and (token, frame+1): every token
    takes >= 1 frame and frames advance strictly, maximizing the summed
    log-probability along the path. -> one (start_frame, end_frame)
    half-open span per token, contiguous and non-overlapping when T >= S;
    with fewer frames than tokens the spans spread evenly and may repeat
    (starts stay non-decreasing)."""
    S, T = attn.shape
    if S == 0:
        return []
    if T < S:  # fewer frames than tokens: spread evenly
        edges = np.linspace(0, T, S + 1).astype(int)
        return [(int(edges[i]), int(max(edges[i + 1], edges[i] + 1))) for i in range(S)]
    logA = np.log(np.maximum(attn, 1e-12))
    NEG = -1e18
    # D[i, j]: best score of a path ending with token i at frame j
    D = np.full((S, T), NEG)
    ptr = np.zeros((S, T), np.uint8)  # 0 = stay on the token's row, 1 = from the row above
    D[0, 0] = logA[0, 0]
    for j in range(1, T):
        D[0, j] = D[0, j - 1] + logA[0, j]
    for i in range(1, S):
        # frame j must be >= token index i (each earlier token took a frame)
        for j in range(i, T - (S - 1 - i)):
            stay = D[i, j - 1]
            up = D[i - 1, j - 1]
            if up >= stay:
                D[i, j] = up + logA[i, j]
                ptr[i, j] = 1
            else:
                D[i, j] = stay + logA[i, j]
    bounds = np.zeros(S, np.int64)  # first frame of each token, backtracked from (S-1, T-1)
    i, j = S - 1, T - 1
    while i > 0:
        if ptr[i, j]:
            bounds[i] = j
            i -= 1
        j -= 1
    spans = []
    for t in range(S):
        start = int(bounds[t])
        end = int(bounds[t + 1]) if t + 1 < S else T
        spans.append((start, max(end, start + 1)))
    return spans


def whisper_token_spans(
    model,
    mel: torch.Tensor,
    gen_ids: np.ndarray,  # [B, G] generated tokens (after the prompt)
    gen_lens: np.ndarray,  # [B] tokens before the first EOT
    prompt: Tuple[int, ...],
    eot: int,
    valid_frames: Optional[np.ndarray] = None,  # [B] encoder frames holding audio
) -> List[List[Tuple[int, int]]]:
    """Per utterance, one (start_frame, end_frame) encoder-frame span per
    generated token. The query rows are the tokens' own input positions
    (the transformers convention for token timestamps); the token horizon
    is rounded up to 8, as in the JAX package (the decoder is causal, so
    the EOT padding never reaches the rows read)."""
    B = gen_ids.shape[0]
    P = len(prompt)
    G = int(gen_lens.max()) if B else 0
    if G == 0:
        return [[] for _ in range(B)]
    G = min(-(-G // 8) * 8, gen_ids.shape[1])
    tokens = np.full((B, P + G), eot, np.int64)
    tokens[:, :P] = np.asarray(prompt, np.int64)[None]
    tokens[:, P:] = gen_ids[:, :G]
    A = cross_attention_matrix(model, mel, tokens)  # [B, P + G, T]
    T = A.shape[-1]
    out: List[List[Tuple[int, int]]] = []
    for b in range(B):
        n = int(gen_lens[b])
        if n == 0:
            out.append([])
            continue
        tv = T if valid_frames is None else max(int(valid_frames[b]), 1)
        out.append(dtw_spans(A[b, P : P + n, : min(tv, T)]))
    return out
