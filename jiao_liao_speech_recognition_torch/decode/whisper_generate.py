"""Whisper autoregressive greedy generation with KV caches, the PyTorch twin
of the JAX package's ``decode/whisper_generate.py`` (greedy half).

The JAX loop is one ``lax.while_loop`` on the device; here the host drives
``decode_step`` on device tensors and reads the stop condition every
``STOP_CHECK_EVERY`` steps. A step past the point where every row is done
only appends EOT to rows that already end in EOT, so the tokens equal the
JAX loop's: the prompt is forced, finished rows emit EOT, and ``lengths``
counts the tokens before the first EOT after the prompt.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.config import DecodeConfig

# Whisper multilingual special tokens (vocab 51865; large-v3 shifts by one)
SOT = 50258
EOT = 50257
TRANSCRIBE = 50359
NO_TIMESTAMPS = 50363
LANG_ZH = 50260
STOP_CHECK_EVERY = 8  # decode steps between host reads of "every row done"


class StepCounter:
    """Decode steps taken by the last generate calls (reset by callers)."""

    def __init__(self):
        self.steps = 0

    def reset(self) -> None:
        self.steps = 0


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
    for pos in range(max_len - 1):
        if pos % STOP_CHECK_EVERY == 0 and pos > 0 and bool(done.all()):
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


def resolve_specials(wcfg) -> Tuple[Tuple[int, ...], int]:
    """(prompt, eot) from a WhisperConfig, defaulting to the standard
    multilingual Whisper tokens."""
    prompt = tuple(wcfg.prompt_ids) or default_prompt(wcfg.vocab_size)
    eot = wcfg.eot_id if wcfg.eot_id >= 0 else EOT
    return prompt, eot


def generate(bundle, mel: torch.Tensor, decode_cfg: DecodeConfig,
             generator: Optional[torch.Generator] = None):
    """The whisper branch of ModelBundle.transcribe: greedy (or temperature
    sampling) up to min(max_decode_len, max_target_positions). A beam of
    one is greedy, as in the JAX package."""
    wcfg = bundle.config.whisper
    if decode_cfg.strategy not in ("greedy", "beam", "beam_device"):
        raise ValueError(f"unknown whisper decode strategy {decode_cfg.strategy!r}")
    if decode_cfg.strategy != "greedy" and decode_cfg.beam_size > 1:
        raise NotImplementedError(
            f"whisper decode strategy {decode_cfg.strategy!r} at beam_size "
            f"{decode_cfg.beam_size}: AR beam search (with the bigram LM) comes with the "
            "Whisper beam slice")
    prompt, eot = resolve_specials(wcfg)
    max_len = min(decode_cfg.max_decode_len, wcfg.max_target_positions)
    return greedy_generate(bundle.model, mel, max_len, prompt, eot, decode_cfg.temperature,
                           generator, wcfg.suppress_ids, wcfg.begin_suppress_ids)
