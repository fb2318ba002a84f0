"""CTC decoding, the PyTorch twin of the JAX package's ``decode/ctc.py``.

Greedy: argmax per frame -> collapse repeats -> drop blanks, the collapse
on the device (cumsum + scatter); only the id -> text lookup needs the host.

Prefix beam search, three searchers with one merge rule (the sum over the
alignments of each collapsed prefix):

* ``ctc_prefix_beam_search``: a fixed-width beam on the device, one step of
  tensor ops a frame (JAX's ``lax.scan`` body) with the frame index in a
  device tensor and the state written in place: each beam expands by
  blank, its last token repeated and the frame's top-k tokens; identical
  prefixes merge by a rolling uint32 hash; the K best go on. On a card a
  chunk of ``FRAMES_PER_REPLAY`` frames is a CUDA graph (utils/graphs.py),
  replayed up to the longest row; on the CPU and with ``graph=False`` the
  frames run eagerly.
* ``ctc_prefix_beam_search_host``: the exact dict-based searcher in numpy,
  with n-gram shallow fusion (``lm`` + ``lm_weight``, decode/lm.py).
* ``ctc_prefix_beam_search_native``: the production route. The device
  prunes each frame to its top-k extension tokens and the blank
  (``ctc_topk_posteriors``), and only those cross to the host, where the
  C++ engine ``native/beam.cpp`` (utils/native_ext.py) runs the beam across
  utterances in threads.

Every top-k here is exact, in ``lax.top_k``'s order: values descending,
equal values by the lowest index (``top_k_exact``; the JAX package's
``approx_max_k`` returns exactly that on the CPU, where its tests run).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..utils import graphs


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


# ---------------------------------------------------------------------------
# exact top-k
# ---------------------------------------------------------------------------


def top_k_exact(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 indices) of the k largest along the last axis in
    lax.top_k's order: descending, equal values by the lowest index.
    One torch.topk over int64 keys that order exactly so (the value's f32
    bits made monotone in the high word, the reversed index in the low
    one), so no tie is left to the library and nothing syncs the host."""
    bits = x.float().view(torch.int32).to(torch.int64)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # sign-magnitude -> ordered
    key.bitwise_left_shift_(32)
    V = x.shape[-1]
    key.bitwise_or_(torch.arange(V - 1, -1, -1, device=x.device))
    idx = torch.topk(key, k, dim=-1).indices
    return x.gather(-1, idx), idx


# ---------------------------------------------------------------------------
# prefix beam search on the device (fixed beam width)
# ---------------------------------------------------------------------------

NEG = -1e30
HASH_MUL = 1000003
U32 = 0xFFFFFFFF


def _masked_logsumexp(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """logsumexp over axis 2 of x[:, None, :] where mask [B, C, C] (the
    JAX function, its + 1e-37 included)."""
    xm = torch.where(mask, x[:, None, :], NEG)
    m = xm.amax(dim=2)
    return m + torch.log(torch.exp(xm - m[..., None]).sum(dim=2) + 1e-37)


FRAMES_PER_REPLAY = 8  # frames in the device beam's captured chunk


@torch.inference_mode()
def ctc_prefix_beam_search(
    log_probs: torch.Tensor,  # [B, T, V]
    lengths: torch.Tensor,  # [B]
    beam_size: int = 8,
    blank_id: int = 0,
    topk_tokens: int = 16,
    graph: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-width CTC prefix beam search on the log-probs' device -> (ids
    [B, T] int32 of the best beam, zero-padded; lengths [B] int32).

    State per beam: the packed prefix, its length, log p_blank / log
    p_nonblank and a rolling uint32 hash of the prefix (kept in int64 and
    wrapped). Each frame expands every beam by {blank, the last token
    repeated, the frame's top-k non-blank tokens}, merges candidates of
    equal hash into their first occurrence (the others die), and keeps the
    K best by lax.top_k's tie order: dead candidates at -1e30 tie, and which
    of them is kept decides the prefixes carried forward. A row past its
    length is frozen; frames past the longest row are not run (on a card
    the last captured chunk runs them frozen). With beam_size=1 this is
    greedy decoding. The scores are f32, or f64 for f64 log-probs (as JAX
    computes in its input's dtype): the host searcher and the C++ engine
    sum in f64, and on flat rows an f32 beam can part from them where
    candidates' scores meet within f32's rounding."""
    B, T, V = log_probs.shape
    K, k = beam_size, min(topk_tokens, V)
    dev = log_probs.device
    lp_all = log_probs if log_probs.dtype == torch.float64 else log_probs.float()
    lp_ext = lp_all.clone()
    lp_ext[..., blank_id] = NEG  # blank is never an extension token
    topv_all, topi_all = top_k_exact(lp_ext, k)  # every frame's proposals at once
    lengths = lengths.to(dev)
    prefixes = torch.zeros(B, K, T, dtype=torch.int32, device=dev)
    plen = torch.zeros(B, K, dtype=torch.int64, device=dev)
    pb = torch.full((B, K), NEG, dtype=lp_all.dtype, device=dev)
    pb[:, 0] = 0.0  # only beam 0 alive
    pnb = torch.full((B, K), NEG, dtype=lp_all.dtype, device=dev)
    ph = torch.zeros(B, K, dtype=torch.int64, device=dev)
    t = torch.zeros(1, dtype=torch.int64, device=dev)  # the frame
    C = K * (k + 1)
    cols = torch.arange(C, device=dev)
    src_beam = torch.arange(K, device=dev).repeat_interleave(k + 1).expand(B, C)
    pos = torch.arange(T, device=dev)
    no_app = torch.full((B, K, 1), -1, dtype=torch.int64, device=dev)

    def frame() -> None:
        ti = t.clamp(max=T - 1)
        lp = lp_all.index_select(1, ti)[:, 0]
        topv, topi = topv_all.index_select(1, ti)[:, 0], topi_all.index_select(1, ti)[:, 0]
        p_total = torch.logaddexp(pb, pnb)
        last = prefixes.gather(2, (plen - 1).clamp_min(0)[..., None])[..., 0].long()
        has_last = plen > 0
        # the prefix unchanged: blank emitted (-> pb), or the last token
        # repeated from pnb (-> pnb)
        new_pb_same = p_total + lp[:, blank_id, None]
        new_pnb_same = torch.where(has_last, pnb + lp.gather(1, last), NEG)
        # appended token v: from pb always, from pnb only when v != last
        tokv = topi[:, None, :].expand(B, K, k)
        same_as_last = (tokv == last[..., None]) & has_last[..., None]
        from_any = torch.logaddexp(pb[..., None], torch.where(same_as_last, NEG, pnb[..., None]))
        ext_pnb = from_any + topv[:, None, :]
        cpb = torch.cat([new_pb_same[..., None], torch.full_like(ext_pnb, NEG)], 2).reshape(B, C)
        cpnb = torch.cat([new_pnb_same[..., None], ext_pnb], 2).reshape(B, C)
        capp = torch.cat([no_app, tokv], 2).reshape(B, C)
        new_hash = (ph[..., None] * HASH_MUL + tokv + 1) & U32
        chash = torch.cat([ph[..., None], new_hash], 2).reshape(B, C)
        clen = torch.cat([plen[..., None], (plen + 1)[..., None].expand(B, K, k)], 2).reshape(B, C)
        # merge equal hashes into the first occurrence; the duplicates die,
        # else a wide beam re-admits them and the next frame counts a prefix twice
        eq = chash[:, :, None] == chash[:, None, :]
        first_occ = torch.where(eq, cols, C).amin(dim=2) == cols
        ctot_pb = torch.where(first_occ, _masked_logsumexp(cpb, eq), NEG)
        ctot_pnb = torch.where(first_occ, _masked_logsumexp(cpnb, eq), NEG)
        score = torch.logaddexp(ctot_pb, ctot_pnb)
        _, top = torch.sort(score, dim=1, descending=True, stable=True)
        top = top[:, :K]
        n_src = src_beam.gather(1, top)
        n_app = capp.gather(1, top)
        n_pref = prefixes.gather(1, n_src[..., None].expand(B, K, T))
        write = (n_app >= 0)[..., None] & (pos == plen.gather(1, n_src)[..., None])
        n_pref = torch.where(write, n_app[..., None].to(torch.int32), n_pref)
        active = ((t < lengths) & (t < T))[:, None]
        prefixes.copy_(torch.where(active[..., None], n_pref, prefixes))
        plen.copy_(torch.where(active, clen.gather(1, top), plen))
        pb.copy_(torch.where(active, ctot_pb.gather(1, top), pb))
        pnb.copy_(torch.where(active, ctot_pnb.gather(1, top), pnb))
        ph.copy_(torch.where(active, chash.gather(1, top), ph))
        t.add_(1)

    n = min(T, int(lengths.max()) if B else 0)
    if graphs.capturing(dev, graph) and n > 1:
        def chunk():
            for _ in range(FRAMES_PER_REPLAY):
                frame()

        graphs.warm(frame, tally=True)  # frame 0 is the warm-up
        cap = graphs.CapturedStep(chunk, tally=True, warmed=True)
        for _ in range(-(-(n - 1) // FRAMES_PER_REPLAY)):
            cap.replay()
    else:
        for _ in range(n):
            frame()
    best = torch.argmax(torch.logaddexp(pb, pnb), dim=1)
    rows = torch.arange(B, device=dev)
    return prefixes[rows, best], plen[rows, best].to(torch.int32)


# ---------------------------------------------------------------------------
# prefix beam search on the host (numpy): exact, with n-gram fusion
# ---------------------------------------------------------------------------


def ctc_prefix_beam_search_host(
    log_probs: np.ndarray,  # [B, T, V] (host)
    lengths: np.ndarray,  # [B]
    beam_size: int = 8,
    blank_id: int = 0,
    topk_tokens: int = 16,
    lm=None,
    lm_weight: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Dict-based prefix beam search -> (ids [B, T] int32, lengths [B]).

    Exact duplicate merging; each frame proposes its top-k non-blank tokens
    in np.argpartition's order, which the sort's tie order then keeps. With
    ``lm`` and ``lm_weight`` > 0 (kenlm-style shallow fusion), every prefix
    extension also pays lm_weight * lm.logp(prefix, v); without them the
    numbers are those of lm=None bit for bit."""
    log_probs = np.asarray(log_probs)
    lengths = np.asarray(lengths)
    B, T, V = log_probs.shape
    k_tok = min(topk_tokens, V - 1)
    out_ids = np.zeros((B, T), np.int32)
    out_len = np.zeros((B,), np.int32)
    fuse = lm is not None and lm_weight > 0.0
    for b in range(B):
        beams = {(): (0.0, NEG)}  # prefix -> (log p_blank, log p_nonblank)
        for t in range(int(lengths[b])):
            lp = log_probs[b, t]
            lp_ext = lp.copy()
            lp_ext[blank_id] = NEG
            top = np.argpartition(-lp_ext, min(k_tok, V - 1))[:k_tok]
            nxt: dict = {}

            def acc(prefix, pb, pnb):
                opb, opnb = nxt.get(prefix, (NEG, NEG))
                nxt[prefix] = (np.logaddexp(opb, pb), np.logaddexp(opnb, pnb))

            for prefix, (pb, pnb) in beams.items():
                p_tot = np.logaddexp(pb, pnb)
                acc(prefix, p_tot + lp[blank_id], NEG)  # emit blank
                if prefix:
                    acc(prefix, NEG, pnb + lp[prefix[-1]])  # repeat last
                for v in top:
                    v = int(v)
                    if v == blank_id:
                        continue
                    src = pb if prefix and v == prefix[-1] else p_tot  # a repeat needs a blank
                    bonus = lm_weight * lm.logp(prefix, v) if fuse else 0.0
                    acc(prefix + (v,), NEG, src + lp[v] + bonus)
            beams = dict(sorted(nxt.items(), key=lambda kv: -np.logaddexp(*kv[1]))[:beam_size])
        best = max(beams.items(), key=lambda kv: np.logaddexp(*kv[1]))[0]
        out_ids[b, : len(best)] = best
        out_len[b] = len(best)
    return out_ids, out_len


# ---------------------------------------------------------------------------
# prefix beam search in C++ over the device's top-k (the production route)
# ---------------------------------------------------------------------------


@torch.inference_mode()
def ctc_topk_posteriors(log_probs: torch.Tensor, k: int, blank_id: int = 0):
    """Per frame, the top-k extension log-probs and ids (blank masked out)
    and the blank's log-prob, on the log-probs' device: only [B, T, k] +
    [B, T] cross to the host instead of the [B, T, V] rows.

    k >= V - 1 (the exactness regime) gives f32 values and int32 ids. Below
    it the transfer dtypes are compact, as in the JAX package: f16 values
    and blank, int16 ids for V < 32768 (else int32); the engine sees the
    f16-rounded numbers, widened on the host."""
    lp_ext = log_probs.clone()
    lp_ext[..., blank_id] = NEG
    V = log_probs.shape[-1]
    vals, ids = top_k_exact(lp_ext, k)
    blank = log_probs[..., blank_id].contiguous()
    if k >= V - 1:
        return vals, ids.to(torch.int32), blank
    return (vals.to(torch.float16), ids.to(torch.int16 if V < 32768 else torch.int32),
            blank.to(torch.float16))


def ctc_prefix_beam_search_native(
    log_probs,  # [B, T, V] tensor (any device) or host array
    lengths,  # [B]
    beam_size: int = 8,
    blank_id: int = 0,
    topk_tokens: int = 64,
    n_threads: int = 0,
    prune_logp: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """CTC prefix beam search by the C++ engine (native/beam.cpp, built at
    first use), threaded across utterances over the device-pruned top-k
    posteriors -> (ids [B, T] int32, lengths [B] int32) on the host.

    The merge rule of ctc_prefix_beam_search_host; the same results when
    topk_tokens >= V - 1 and prune_logp >= 0. prune_logp < 0 drops a
    frame's candidates more than |prune_logp| nats below its best mass. The
    repeat-last expansion reads lp[last] from the frame's pruned list
    (absent -> -inf)."""
    from ..utils.native_ext import load_beam

    beam = load_beam()  # build (or raise) before any device work
    log_probs = torch.as_tensor(log_probs)
    k = min(topk_tokens, log_probs.shape[-1] - 1)
    vals, ids, blank = (t.cpu().numpy() for t in ctc_topk_posteriors(log_probs, k, blank_id))
    lengths = lengths.cpu().numpy() if torch.is_tensor(lengths) else np.asarray(lengths)
    return beam.search(vals, ids, blank, lengths, beam_size, n_threads, prune_logp)
