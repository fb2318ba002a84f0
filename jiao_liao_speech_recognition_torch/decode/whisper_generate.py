"""Autoregressive generation with KV caches, the PyTorch twin of the JAX
package's ``decode/whisper_generate.py``: greedy (and temperature
sampling) and the batched beam search, generic over any model with
``init_cache`` / ``decode_step`` (Whisper, and the joint CTC/attention
model through ``decode/joint_generate.py``), with the n-gram LM's bigram
matrix as on-device shallow fusion.

The JAX loops are each one ``lax.while_loop`` on the device; here the host
drives ``decode_step`` on device tensors and reads the stop condition every
``STOP_CHECK_EVERY`` steps. A greedy step past the point where every row is
done only appends EOT to rows that already end in EOT; a beam step there
is masked to leave the state as it is (the JAX loop has stopped). So the
tokens equal the JAX loops': the prompt is forced, finished rows emit EOT,
and ``lengths`` counts the tokens before the first EOT after the prompt.

On a tensor-parallel model (parallel/tp.py) every rank of a model group
runs the same steps on the same rows: its logits are the group's joined
vocab columns, so each rank takes the same tokens, and the greedy loop's
host read of "every row done" is agreed over the group before it stops.
The beam loop needs no collective of its own: its log-probs, top-K
bookkeeping and host reads are the same bytes on every rank, and the self
caches it gathers along the winning beams hold the rank's heads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.tp import model_tp
from ..utils.config import DecodeConfig

# Whisper multilingual special tokens (vocab 51865; large-v3 shifts by one)
SOT = 50258
EOT = 50257
TRANSCRIBE = 50359
NO_TIMESTAMPS = 50363
LANG_ZH = 50260
STOP_CHECK_EVERY = 8  # decode steps between host reads of "every row done"


class StepCounter:
    """Decode steps, and teacher-forced verification passes of speculative
    greedy, taken by the last generate calls (reset by callers)."""

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
                    layout: Optional[str] = None, kernels: bool = True):
    """mel [B, mels, T] -> (tokens [B, max_len - P], lengths [B])."""
    prompt = prompt or default_prompt(model.cfg.vocab_size)
    with torch.inference_mode():
        enc = model.encode(mel, kernels)
    return greedy_from_enc(model, enc, None, max_len, prompt, eot_id, temperature, generator,
                           suppress_ids, begin_suppress_ids, layout, kernels)


@torch.inference_mode()
def greedy_from_enc(model, enc: torch.Tensor, enc_lengths: Optional[torch.Tensor] = None,
                    max_len: int = 224, prompt: Tuple[int, ...] = (), eot_id: int = EOT,
                    temperature: float = 0.0, generator: Optional[torch.Generator] = None,
                    suppress_ids: Tuple[int, ...] = (), begin_suppress_ids: Tuple[int, ...] = (),
                    layout: Optional[str] = None, kernels: bool = True):
    """The greedy loop over an encoder output [B, T, d]. temperature > 0
    samples softmax(logits / T) with `generator` (a torch.Generator on the
    encoder's device; the JAX loop's jax.random draws differ)."""
    B, dev = enc.shape[0], enc.device
    P = len(prompt)
    always, begin = suppression_masks(model.cfg.vocab_size, suppress_ids, begin_suppress_ids, dev)
    caches = model.init_cache(B, enc, max_len, layout)
    tokens = torch.full((B, max_len), eot_id, dtype=torch.long, device=dev)
    tokens[:, :P] = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    tp = model_tp(model)
    for pos in range(max_len - 1):
        if pos % STOP_CHECK_EVERY == 0 and pos > 0:
            stop = bool(done.all())
            if tp is not None and tp.size > 1:
                stop = tp.agree(stop)
            if stop:
                break
        logits, caches = model.decode_step(tokens[:, pos:pos + 1], pos, enc, caches,
                                           enc_lengths, kernels)
        STEPS.steps += 1
        if pos + 1 < P:  # forced prompt token
            continue
        logits = apply_suppression(logits, pos, P, always, begin)
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(done, torch.full_like(nxt, eot_id), nxt)
        tokens[:, pos + 1] = nxt
        done |= nxt == eot_id
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
                  kernels: bool = True):
    """Beam search -> the best beam per utterance (tokens [B, max_len - P],
    lengths [B]): the highest score / max(length, 1) ** length_penalty,
    the first beam among equals."""
    prompt = prompt or default_prompt(model.cfg.vocab_size)
    with torch.inference_mode():
        enc = model.encode(mel, kernels)
    gen, lengths, scores = beam_from_enc(model, enc, None, beam_size, max_len, prompt, eot_id,
                                         lm_bigram, lm_weight, suppress_ids, begin_suppress_ids,
                                         layout, kernels)
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
                  kernels: bool = True):
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
    P_LM(next | current token) to each step's log-probs."""
    B, dev = enc.shape[0], enc.device
    K, P, V = beam_size, len(prompt), model.cfg.vocab_size
    always, begin = suppression_masks(V, suppress_ids, begin_suppress_ids, dev)
    caches = model.init_cache(B, enc, max_len, layout, beams=K)
    lens_k = None if enc_lengths is None else enc_lengths.to(dev).repeat_interleave(K, 0)
    tokens = torch.full((B, K, max_len), eot_id, dtype=torch.long, device=dev)
    tokens[:, :, :P] = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    scores = torch.full((B, K), NEG, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros(B, K, dtype=torch.bool, device=dev)
    eot_only = torch.full((V,), NEG, dtype=torch.float32, device=dev)
    eot_only[eot_id] = 0.0
    beams = torch.arange(K, device=dev).expand(B, K)
    row0 = torch.arange(B, device=dev)[:, None] * K
    fuse = lm_bigram is not None and lm_weight > 0.0
    for pos in range(max_len - 1):
        if pos % STOP_CHECK_EVERY == 0 and pos > 0 and bool(finished.all()):
            break
        live = ~finished.all()  # on the device: once every beam is done a step changes nothing
        tok = tokens[:, :, pos].reshape(B * K, 1)
        logits, caches = model.decode_step(tok, pos, enc, caches, lens_k, kernels)
        STEPS.steps += 1
        logp = log_softmax_f32(apply_suppression(logits, pos, P, always, begin)).reshape(B, K, V)
        if fuse:
            logp = logp + lm_weight * lm_bigram[tok[:, 0]].reshape(B, K, V)
        logp = torch.where(finished[..., None], eot_only, logp)
        in_prompt = pos + 1 < P
        if in_prompt:  # forced decoding: every beam continues with the prompt token
            new_tok = tokens[:, :, pos + 1]
            new_scores = scores + logp.gather(2, new_tok[..., None])[..., 0]
            src = beams
        else:
            new_scores, idx = top_k_stable((scores[..., None] + logp).reshape(B, K * V), K)
            src, new_tok = idx // V, idx % V
        src = torch.where(live, src, beams)
        scores = torch.where(live, new_scores, scores)
        tokens = tokens.gather(1, src[..., None].expand(B, K, max_len))
        finished = finished.gather(1, src)
        new_tok = torch.where(finished | ~live, eot_id, new_tok)
        tokens[:, :, pos + 1] = new_tok
        if not in_prompt:
            finished = finished | (new_tok == eot_id)
        rows = (row0 + src).reshape(-1)
        for c in caches.values():
            c["self"] = {n: t.index_select(0, rows) for n, t in c["self"].items()}
            if "slots" in c:  # an Att adapter's caches follow their beams too
                c["slots"] = {s: {n: t.index_select(0, rows) for n, t in slot.items()}
                              for s, slot in c["slots"].items()}
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
             generator: Optional[torch.Generator] = None):
    """The whisper branch of ModelBundle.transcribe, up to
    min(max_decode_len, max_target_positions): greedy (or temperature
    sampling), or for "beam" / "beam_device" at beam_size > 1 the beam
    search with the bigram LM's shallow fusion when decode_cfg names an LM
    with lm_weight > 0. A beam of one is greedy, as in the JAX package."""
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
                             wcfg.suppress_ids, wcfg.begin_suppress_ids)
    return greedy_generate(bundle.model, mel, max_len, prompt, eot, decode_cfg.temperature,
                           generator, wcfg.suppress_ids, wcfg.begin_suppress_ids)
