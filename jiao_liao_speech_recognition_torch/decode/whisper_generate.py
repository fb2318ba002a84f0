"""Autoregressive generation with KV caches, the PyTorch twin of the JAX
package's ``decode/whisper_generate.py``: greedy (and temperature
sampling) and the batched beam search, generic over any model with
``init_cache`` / ``decode_step`` (Whisper, and the joint CTC/attention
model through ``decode/joint_generate.py``), with the n-gram LM's bigram
matrix as on-device shallow fusion.

The JAX loops are each one ``lax.while_loop`` on the device. Here each
loop's step body keeps its state in tensors written in place (tokens,
scores, done flags, the caches) and its position in a device tensor, so
on a card the loop is a CUDA graph (utils/graphs.py): the forced prompt
steps and the first generated step (step 0 under an empty prompt) run
eagerly as the warm-up, then a chunk of ``STOP_CHECK_EVERY`` steps is
captured and replayed, with one host read of "every row done" after each
replay, the counterpart of the JAX loop's ``cond_fn``. Temperature
sampling is captured too, its generator registered with the graph. A step
past the point where every row is done, or past the last position
(``max_len - 1``), is masked on the device: it writes only EOT, or
nothing, and leaves the beam as it is. So the tokens equal the JAX loops':
the prompt is forced, finished rows emit EOT, and ``lengths`` counts the
tokens before the first EOT after the prompt. On the CPU, and with
``graph=False``, the same steps run eagerly. ``greedy_step`` is also the
serving engine's step (serve/engine.py), at each lane's own position.

On a tensor-parallel model (parallel/tp.py) every rank of a model group
runs the same steps on the same rows: its logits are the group's joined
vocab columns, so each rank takes the same tokens, and the greedy loop's
host read of "every row done" is agreed over the group before it stops.
The beam loop needs no collective of its own: its log-probs, top-K
bookkeeping and host reads are the same bytes on every rank, and the self
caches it gathers along the winning beams hold the rank's heads. A split
model's loop is captured with its collectives (``check_capturable``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.tp import model_tp
from ..utils import graphs
from ..utils.config import DecodeConfig

# Whisper multilingual special tokens (vocab 51865; large-v3 shifts by one)
SOT = 50258
EOT = 50257
TRANSCRIBE = 50359
NO_TIMESTAMPS = 50363
LANG_ZH = 50260
STOP_CHECK_EVERY = 8  # decode steps between host reads of "every row done": a captured chunk


class StepCounter:
    """Decode steps (eager or replayed), and teacher-forced verification
    passes of speculative greedy, taken by the last generate calls (reset
    by callers)."""

    def __init__(self):
        self.steps = 0
        self.passes = 0

    def reset(self) -> None:
        self.steps = 0
        self.passes = 0


STEPS = StepCounter()


def default_prompt(vocab_size: int = 51865) -> Tuple[int, ...]:
    """<|startoftranscript|><|zh|><|transcribe|><|notimestamps|>."""
    shift = 1 if vocab_size == 51866 else 0  # large-v3 adds a language token
    return (SOT + shift, LANG_ZH + shift, TRANSCRIBE + shift, NO_TIMESTAMPS + shift)


def suppression_masks(vocab_size: int, suppress_ids, begin_suppress_ids, device="cpu"):
    """(always, begin) additive f32 [V] logit masks (-1e30 at the ids), or
    None when empty: transformers' generate() suppression."""
    def mask(ids):
        if not ids:
            return None
        m = torch.zeros(vocab_size, dtype=torch.float32, device=device)
        m[torch.as_tensor(list(ids), dtype=torch.long, device=device)] = -1e30
        return m

    return mask(suppress_ids), mask(begin_suppress_ids)


def apply_suppression(logits, pos: int, prompt_len: int, always, begin):
    """Add the masks to [.., V] logits at decode position `pos` (the token
    predicted lands at pos + 1; the first generated one at prompt_len)."""
    if always is not None:
        logits = logits + always
    if begin is not None and pos + 1 == prompt_len:
        logits = logits + begin
    return logits


def apply_suppression_rows(logits, pos: torch.Tensor, prompt_len: int, always, begin):
    """apply_suppression with one position a row (pos [B], the serving
    engine's lanes): the begin mask lands on the rows whose next token is
    the first generated one. Decided on the device, so a captured step
    replays it for any positions."""
    if always is not None:
        logits = logits + always
    if begin is not None:
        logits = torch.where((pos + 1 == prompt_len)[:, None], logits + begin, logits)
    return logits


def greedy_generate(model, mel: torch.Tensor, max_len: int = 224,
                    prompt: Optional[Tuple[int, ...]] = None, eot_id: int = EOT,
                    temperature: float = 0.0, generator: Optional[torch.Generator] = None,
                    suppress_ids: Tuple[int, ...] = (), begin_suppress_ids: Tuple[int, ...] = (),
                    layout: Optional[str] = None, kernels: bool = True, graph: bool = True):
    """mel [B, mels, T] -> (tokens [B, max_len - P], lengths [B])."""
    prompt = prompt or default_prompt(model.cfg.vocab_size)
    with torch.inference_mode():
        enc = model.encode(mel, kernels)
    return greedy_from_enc(model, enc, None, max_len, prompt, eot_id, temperature, generator,
                           suppress_ids, begin_suppress_ids, layout, kernels, graph)


def greedy_step(model, tokens: torch.Tensor, pos: torch.Tensor, done: torch.Tensor,
                enc: torch.Tensor, caches, enc_lengths: Optional[torch.Tensor], prompt_len: int,
                max_len: int, eot_id: int, always, begin, kernels: bool = True,
                pick=None) -> None:
    """One greedy decode step of every row, in place on tokens [B, max_len],
    pos [B] int64 (each row's position) and done [B] (the JAX loop's body;
    the serving engine's step at its lanes' positions): the token at pos is
    fed, prompt tokens are forced (pos + 1 < prompt_len), finished rows
    write EOT and stay at their position, and a row at its last position
    writes nothing and is done. ``pick`` maps the logits to the next ids
    (argmax when None). Nothing here reads the device from the host, so a
    CUDA graph captures it."""
    logits, _ = model.decode_step(tokens.gather(1, pos[:, None]), pos, enc, caches,
                                  enc_lengths, kernels)
    logits = apply_suppression_rows(logits, pos, prompt_len, always, begin)
    nxt = torch.argmax(logits, dim=-1) if pick is None else pick(logits)
    in_row = pos + 1 < max_len
    at = torch.where(in_row, pos + 1, pos)
    cur_next = tokens.gather(1, at[:, None])[:, 0]
    is_prompt = pos + 1 < prompt_len
    nxt = torch.where(done, eot_id, torch.where(is_prompt, cur_next, nxt))
    nxt = torch.where(in_row, nxt, cur_next)
    tokens.scatter_(1, at[:, None], nxt[:, None])
    active = ~done
    done |= (active & ~is_prompt & (nxt == eot_id)) | (pos + 1 >= max_len - 1)
    pos.copy_(torch.where(active, pos + 1, pos))


def sample_ids(logits: torch.Tensor, temperature: float,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One draw a row from softmax(logits / temperature) [.., V] -> ids, with
    `generator` (the default generator of the logits' device when None).
    torch.multinomial reads nothing back to the host, so a captured step
    draws with it too."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]


def _run_loop(step, n: int, first: int, stop, capture: bool, per_replay: int = STOP_CHECK_EVERY,
              generator: Optional[torch.Generator] = None) -> int:
    """Drive `step(p)` (p the host's step index) for up to n steps -> the
    steps run. The first `first` steps run eagerly (with capture, as the
    warm-up on the side stream, and at least one: under an empty prompt
    step 0, which the JAX loop runs too). Then, while stop() is false,
    chunks of `per_replay` steps: with capture, the chunk is captured at
    the first one needed and replayed (each replay runs all `per_replay`
    steps, masked on the device past the end); else eagerly up to n.
    `generator` is registered with the graph (``CapturedStep``)."""
    p = 0

    def eager(k: int) -> None:
        nonlocal p
        for _ in range(k):
            step(p)
            p += 1

    if capture:
        first = max(first, min(1, n))
        graphs.warm(lambda: eager(first), tally=True)
    else:
        eager(first)
    cap = None
    while p < n and not stop():
        if not capture:
            eager(min(per_replay, n - p))
            continue
        if cap is None:
            start = p

            def chunk():
                for i in range(per_replay):
                    step(start + i)  # steps past the warm-up: one body for every position

            cap = graphs.CapturedStep(chunk, tally=True, warmed=True, generator=generator)
        cap.replay()
        p += per_replay
    return p


@torch.inference_mode()
def greedy_from_enc(model, enc: torch.Tensor, enc_lengths: Optional[torch.Tensor] = None,
                    max_len: int = 224, prompt: Tuple[int, ...] = (), eot_id: int = EOT,
                    temperature: float = 0.0, generator: Optional[torch.Generator] = None,
                    suppress_ids: Tuple[int, ...] = (), begin_suppress_ids: Tuple[int, ...] = (),
                    layout: Optional[str] = None, kernels: bool = True, graph: bool = True):
    """The greedy loop over an encoder output [B, T, d], every row at one
    position (``greedy_step``); captured on a card unless graph=False.
    temperature > 0 samples softmax(logits / T) with `generator` (a
    torch.Generator on the encoder's device, or its default generator;
    ``sample_ids``), captured as greedy is, the generator registered with
    the graph: a replayed chunk draws what its eager steps would. The
    masked steps of the last chunk draw too, so the generator may end
    ahead of where the eager route leaves it; the tokens are the same. The
    JAX loop's jax.random draws differ: the bar against it is the
    distribution."""
    B, dev = enc.shape[0], enc.device
    P = len(prompt)
    capture = graphs.capturing(dev, graph, model, "greedy_from_enc")
    always, begin = suppression_masks(model.cfg.vocab_size, suppress_ids, begin_suppress_ids, dev)
    caches = model.init_cache(B, enc, max_len, layout)
    tokens = torch.full((B, max_len), eot_id, dtype=torch.long, device=dev)
    tokens[:, :P] = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    pos = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    tp = model_tp(model)

    def sample(logits):
        return sample_ids(logits, temperature, generator)

    def step(p: int) -> None:
        pick = sample if temperature > 0 and p + 1 >= P else None
        greedy_step(model, tokens, pos, done, enc, caches, enc_lengths, P, max_len, eot_id,
                    always, begin, kernels, pick)

    def stop() -> bool:
        flag = bool(done.all())
        return tp.agree(flag) if tp is not None and tp.size > 1 else flag

    n = max_len - 1  # the JAX loop's steps when no row ends
    steps = _run_loop(step, n, min(P, n), stop, capture,
                      generator=generator if temperature > 0 else None)
    STEPS.steps += steps  # read after the loop: a split model's ranks may be threads
    gen = tokens[:, P:]
    is_eot = gen == eot_id
    first = torch.argmax(is_eot.to(torch.int32), dim=1)
    lengths = torch.where(is_eot.any(dim=1), first, torch.full_like(first, gen.shape[1]))
    return gen, lengths


NEG = -1e30  # a dead beam's score, and every non-EOT continuation of a finished beam


def log_softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    """jax.nn.log_softmax of the f32 logits, in its order of operations."""
    x = logits.float()
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis in lax.top_k's
    order: descending, equal values by the lowest index first (torch.topk
    promises no order among ties on a card)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def beam_generate(model, mel: torch.Tensor, beam_size: int = 4, max_len: int = 224,
                  length_penalty: float = 1.0, prompt: Optional[Tuple[int, ...]] = None,
                  eot_id: int = EOT, lm_bigram: Optional[torch.Tensor] = None,
                  lm_weight: float = 0.0, suppress_ids: Tuple[int, ...] = (),
                  begin_suppress_ids: Tuple[int, ...] = (), layout: Optional[str] = None,
                  kernels: bool = True, graph: bool = True):
    """Beam search -> the best beam per utterance (tokens [B, max_len - P],
    lengths [B]): the highest score / max(length, 1) ** length_penalty,
    the first beam among equals."""
    prompt = prompt or default_prompt(model.cfg.vocab_size)
    with torch.inference_mode():
        enc = model.encode(mel, kernels)
    gen, lengths, scores = beam_from_enc(model, enc, None, beam_size, max_len, prompt, eot_id,
                                         lm_bigram, lm_weight, suppress_ids, begin_suppress_ids,
                                         layout, kernels, graph)
    return best_beam(gen, lengths, scores / length_norm(lengths, length_penalty))


def length_norm(lengths: torch.Tensor, length_penalty: float) -> torch.Tensor:
    return lengths.clamp_min(1).float() ** length_penalty


def best_beam(gen: torch.Tensor, lengths: torch.Tensor, ranking: torch.Tensor):
    """The beam of each row with the highest `ranking` [B, K] (the first
    among equals) -> (tokens [B, L], lengths [B])."""
    best = torch.argmax(ranking, dim=1)
    rows = torch.arange(gen.shape[0], device=gen.device)
    return gen[rows, best], lengths[rows, best]


@torch.inference_mode()
def beam_from_enc(model, enc: torch.Tensor, enc_lengths: Optional[torch.Tensor] = None,
                  beam_size: int = 4, max_len: int = 224, prompt: Tuple[int, ...] = (),
                  eot_id: int = EOT, lm_bigram: Optional[torch.Tensor] = None,
                  lm_weight: float = 0.0, suppress_ids: Tuple[int, ...] = (),
                  begin_suppress_ids: Tuple[int, ...] = (), layout: Optional[str] = None,
                  kernels: bool = True, graph: bool = True):
    """The beam loop over an encoder output [B, T, d] -> every beam:
    (tokens [B, K, max_len - P], lengths [B, K], scores [B, K] f32, summed
    log-probs). Beams fold into the batch (row b * K + k); each step scores
    the K * V continuations of every utterance, keeps the top K
    (``top_k_stable``) and gathers the self caches along the winning beams.
    The cross caches are projected once per utterance and repeated K times
    (``init_cache(..., beams=K)``); the K beams of an utterance share their
    cross K/V, so they are never gathered (an Att adapter's slot caches
    are, as the self caches). Finished beams continue with EOT
    at log-prob 0 only; only beam 0 starts alive. ``lm_bigram`` [V, V]
    (``load_bigram_matrix``) with lm_weight > 0 adds lm_weight * log
    P_LM(next | current token) to each step's log-probs.

    The state is written in place (each gather goes through a new tensor
    and ``copy_``), so on a card the steps after the forced prompt are
    captured (``_run_loop``) unless graph=False. A step once every beam is
    finished, or past the last position, leaves the state as it is."""
    B, dev = enc.shape[0], enc.device
    K, P, V = beam_size, len(prompt), model.cfg.vocab_size
    capture = graphs.capturing(dev, graph, model, "beam_from_enc")
    always, begin = suppression_masks(V, suppress_ids, begin_suppress_ids, dev)
    caches = model.init_cache(B, enc, max_len, layout, beams=K)
    lens_k = None if enc_lengths is None else enc_lengths.to(dev).repeat_interleave(K, 0)
    tokens = torch.full((B, K, max_len), eot_id, dtype=torch.long, device=dev)
    tokens[:, :, :P] = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    scores = torch.full((B, K), NEG, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros(B, K, dtype=torch.bool, device=dev)
    pos = torch.zeros(B * K, dtype=torch.long, device=dev)  # every beam at one position
    eot_only = torch.full((V,), NEG, dtype=torch.float32, device=dev)
    eot_only[eot_id] = 0.0
    beams = torch.arange(K, device=dev).expand(B, K)
    row0 = torch.arange(B, device=dev)[:, None] * K
    fuse = lm_bigram is not None and lm_weight > 0.0
    leaves = [t for c in caches.values() for t in c["self"].values()]
    for c in caches.values():  # an Att adapter's caches follow their beams too
        leaves += [t for slot in c.get("slots", {}).values() for t in slot.values()]

    def step(p: int) -> None:
        forced = p + 1 < P  # forced decoding: every beam continues with the prompt token
        live = ~finished.all()  # on the device: once every beam is done a step changes nothing
        in_row = pos[:1] + 1 < max_len  # [1]: past the last position nothing is written
        tok = tokens.gather(2, pos.view(B, K, 1)).reshape(B * K, 1)
        logits, _ = model.decode_step(tok, pos, enc, caches, lens_k, kernels)
        logp = log_softmax_f32(apply_suppression_rows(logits, pos, P, always, begin))
        logp = logp.reshape(B, K, V)
        if fuse:
            logp = logp + lm_weight * lm_bigram[tok[:, 0]].reshape(B, K, V)
        logp = torch.where(finished[..., None], eot_only, logp)
        at = torch.where(in_row, pos + 1, pos).view(B, K, 1)
        if forced:
            new_tok = tokens.gather(2, at)[..., 0]
            new_scores = scores + logp.gather(2, new_tok[..., None])[..., 0]
            src = beams
        else:
            new_scores, idx = top_k_stable((scores[..., None] + logp).reshape(B, K * V), K)
            src, new_tok = idx // V, idx % V
        go = live & in_row
        src = torch.where(go, src, beams)
        scores.copy_(torch.where(go, new_scores, scores))
        tokens.copy_(tokens.gather(1, src[..., None].expand(B, K, max_len)))
        finished.copy_(finished.gather(1, src))
        new_tok = torch.where(finished | ~live, eot_id, new_tok)
        new_tok = torch.where(in_row, new_tok, tokens.gather(2, at)[..., 0])
        tokens.scatter_(2, at, new_tok[..., None])
        if not forced:
            finished.logical_or_(in_row & (new_tok == eot_id))
        rows = (row0 + src).reshape(-1)
        for t in leaves:
            t.copy_(t.index_select(0, rows))
        pos.copy_(torch.where(in_row, pos + 1, pos))

    n = max_len - 1
    steps = _run_loop(step, n, min(P, n), lambda: bool(finished.all()), capture)
    STEPS.steps += steps
    gen = tokens[:, :, P:]
    is_eot = gen == eot_id
    first = torch.argmax(is_eot.to(torch.int32), dim=2)
    lengths = torch.where(is_eot.any(dim=2), first, torch.full_like(first, gen.shape[2]))
    return gen, lengths, scores


def load_bigram_matrix(lm_path: str, vocab_size: int, device="cpu") -> torch.Tensor:
    """An NGramCharLM file -> its [vocab_size, vocab_size] f32 bigram
    log-prob matrix on `device` for on-device fusion; ids past the LM's
    vocabulary (model specials) take the matrix's median, so the LM
    neither boosts nor kills them."""
    import numpy as np

    from .lm import NGramCharLM

    mat = NGramCharLM.load(lm_path).bigram_log_matrix()
    V = vocab_size
    if mat.shape[0] < V:
        out = np.full((V, V), float(np.median(mat)), np.float32)
        out[: mat.shape[0], : mat.shape[1]] = mat
        mat = out
    return torch.from_numpy(np.ascontiguousarray(mat[:V, :V])).to(device)


def resolve_specials(wcfg) -> Tuple[Tuple[int, ...], int]:
    """(prompt, eot) from a WhisperConfig, defaulting to the standard
    multilingual Whisper tokens."""
    prompt = tuple(wcfg.prompt_ids) or default_prompt(wcfg.vocab_size)
    eot = wcfg.eot_id if wcfg.eot_id >= 0 else EOT
    return prompt, eot


def generate(bundle, mel: torch.Tensor, decode_cfg: DecodeConfig,
             generator: Optional[torch.Generator] = None, graph: bool = True):
    """The whisper branch of ModelBundle.transcribe, up to
    min(max_decode_len, max_target_positions): greedy (or temperature
    sampling), or for "beam" / "beam_device" at beam_size > 1 the beam
    search with the bigram LM's shallow fusion when decode_cfg names an LM
    with lm_weight > 0. A beam of one is greedy, as in the JAX package.
    graph=False steps eagerly on a card."""
    wcfg = bundle.config.whisper
    if decode_cfg.strategy not in ("greedy", "beam", "beam_device"):
        raise ValueError(f"unknown whisper decode strategy {decode_cfg.strategy!r}")
    prompt, eot = resolve_specials(wcfg)
    max_len = min(decode_cfg.max_decode_len, wcfg.max_target_positions)
    if decode_cfg.strategy != "greedy" and decode_cfg.beam_size > 1:
        lm = None
        if decode_cfg.lm_path and decode_cfg.lm_weight > 0.0:
            lm = load_bigram_matrix(decode_cfg.lm_path, wcfg.vocab_size, mel.device)
        return beam_generate(bundle.model, mel, decode_cfg.beam_size, max_len,
                             decode_cfg.length_penalty, prompt, eot, lm, decode_cfg.lm_weight,
                             wcfg.suppress_ids, wcfg.begin_suppress_ids, graph=graph)
    return greedy_generate(bundle.model, mel, max_len, prompt, eot, decode_cfg.temperature,
                           generator, wcfg.suppress_ids, wcfg.begin_suppress_ids, graph=graph)
