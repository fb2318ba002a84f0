"""Continuous-batching serving engine for Whisper AR decode, the PyTorch
twin of the JAX package's ``serve/engine.py``.

Static batches wait for their longest utterance; this engine keeps a fixed
pool of ``slots`` decode lanes and admits utterances mid-flight as lanes
free up:

* each lane sits at its own decode position, so the step calls
  ``decode_step`` with a [S] position tensor (per-row position embedding,
  key mask, kernel lengths and cache-row writes);
* admission is one batched wave: the queued newcomers are featurized (K1),
  encoded (K5, K6, K2h-out, K3c at large-v3's width) and their caches built
  together, in the pool's layout, then copied into their free lanes. Only
  the admitted rows are encoded (the JAX engine pads the wave to S rows
  for its static shapes and drops the padding through an out-of-range
  scatter);
* a dispatch runs ``steps_per_dispatch`` decode steps, then reads ``done``
  and the token pool back in one device-to-host copy and harvests the
  finished lanes; idle lanes stay frozen at their position.

On the card the decode step is replayed from a CUDA graph, the
counterpart of the JAX engine's ``lax.fori_loop`` inside one jit: one step
(the decoder's blocks with K9, or K10 / K9-int8 for a ``quantize()``d
bundle, the tied logits (K11 when int8), suppression, argmax and the lanes'
bookkeeping) is warmed on a side stream, captured once at construction and
replayed ``steps_per_dispatch`` times a dispatch. Its state (tokens,
positions, done flags, the cache pool, the encoder outputs) is allocated
once; admission and harvest write into it in place and never rebind it, so
the addresses the graph recorded, those inside the kernels' TMA
descriptors included, stay valid; so do those of the weights and their
serving copies, so an engine serves the weights it was made with (make a
new one after changing them). A capture or replay that fails raises. On
a CPU bundle the same step runs eagerly. An adapted bundle serves as it
is: WF inserts sit in the Dense layers (K7 in the admission's encoder);
an Att adapter's slot caches are lanes of the pool like the self caches,
written at each lane's position.

A split bundle (``ModelBundle.shard``, a model axis over a process group)
serves as one card's: every rank of a model group makes the same engine,
takes the same submissions, admits and harvests the same lanes (its
logits are the group's joined vocab columns, so its tokens, done flags
and texts are the same bytes on each rank) and holds its heads' caches.
The captured step holds the row layers' NCCL all-reduces and the vocab
all-gather; the warm-up runs them first, so the communicators exist before
the capture (NCCL capture also wants ``TORCH_NCCL_ASYNC_ERROR_HANDLING=0``
before the group starts, which ``parallel/multihost.initialize`` sets when
asked for ``graph_collectives``; the engine refuses to capture without
it). A
stand-in group (parallel/tp.py: ranks played in one process) cannot be
captured: the engine refuses one on a card unless ``graph=False`` asks
for the eager step.

Greedy only, as in the JAX package.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..decode.whisper_generate import greedy_step, resolve_specials, suppression_masks
from ..frontend import features
from ..models.ctc_model import DTYPES
from ..models.whisper import HEAD_MAJOR_MIN_BATCH
from ..parallel.tp import check_capturable
from ..utils.graphs import CapturedStep


@dataclass
class _Request:
    rid: int
    wav: np.ndarray  # padded or trimmed to the model window
    submitted_at: float
    wav_len: int = 0  # samples before padding (the timestamps' frame clamp)
    started_at: float = 0.0
    finished_at: float = 0.0
    text: Optional[str] = None
    timed: Optional[list] = None  # [{"token", "start", "end"}] with timestamps
    ids: Optional[List[int]] = None  # generated ids before the first EOT


@dataclass
class ServingStats:
    """Serving metrics since the engine was made."""

    completed: int = 0
    decode_steps: int = 0
    dispatches: int = 0
    waves: int = 0  # admission waves (one batched encoder pass each)
    latencies_s: List[float] = field(default_factory=list)

    @property
    def mean_latency_s(self) -> float:
        return float(np.mean(self.latencies_s)) if self.latencies_s else 0.0

    @property
    def p95_latency_s(self) -> float:
        return float(np.percentile(self.latencies_s, 95)) if self.latencies_s else 0.0


def _rows_of_zeros(tree, rows: int):
    """The cache tree `tree` with every tensor zeroed at `rows` rows (the
    self, cross and any Att adapter slot caches alike)."""
    if isinstance(tree, dict):
        return {k: _rows_of_zeros(v, rows) for k, v in tree.items()}
    return torch.zeros((rows, *tree.shape[1:]), dtype=tree.dtype, device=tree.device)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _leaves(tree[key])]
    return [tree]


class ServingEngine:
    """Continuous-batching greedy transcription over a fixed slot pool::

        eng = ServingEngine(bundle, slots=8)
        rid = eng.submit(wav)          # queues, and admits at once if a lane is free
        texts = eng.drain()            # {rid: text} once every request is done
        texts = eng.transcribe([wav1, wav2, ...])  # in order, long-form re-joined

    On a card the step is captured at construction; ``graph=False`` runs
    it eagerly instead (the comparisons of a captured step with its eager
    self, and a model group played in one process).
    """

    def __init__(self, bundle, slots: int = 8, steps_per_dispatch: int = 32,
                 max_len: Optional[int] = None, timestamps: bool = False, graph: bool = True):
        if not bundle.is_whisper:
            raise ValueError(
                "ServingEngine drives AR decode; the CTC family is a single forward pass "
                "per batch: use bundle.transcribe")
        if graph:
            check_capturable(bundle.model, bundle.device, "ServingEngine")
        self.bundle = bundle
        self.cfg = bundle.config
        wcfg = self.cfg.whisper
        self.model = bundle.model
        self.slots = int(slots)
        self.steps_per_dispatch = int(steps_per_dispatch)
        self.max_len = min(int(max_len or self.cfg.decode.max_decode_len),
                           wcfg.max_target_positions)
        # word timing at harvest: one B=1 teacher-forced alignment pass per
        # finished request (decode/align.py), off the decode loop
        self.timestamps = bool(timestamps)
        self.prompt, self.eot = resolve_specials(wcfg)
        self._P = len(self.prompt)
        dev = self.device = bundle.device
        self._always, self._begin = suppression_masks(
            wcfg.vocab_size, wcfg.suppress_ids, wcfg.begin_suppress_ids, dev)
        fe = self.cfg.frontend
        self._window = int(fe.chunk_seconds * fe.sample_rate)
        # the pool's cache layout, decided once for a batch of S as
        # init_cache decides it (below HEAD_MAJOR_MIN_BATCH any batch of
        # admitted rows gets the same decision as S rows)
        self._layout = "head_major" if self.slots >= HEAD_MAJOR_MIN_BATCH else None
        S = self.slots
        with torch.no_grad():
            fresh = torch.full((self.max_len,), self.eot, dtype=torch.long, device=dev)
            fresh[: self._P] = torch.as_tensor(self.prompt, dtype=torch.long)
            self._fresh_row = fresh
            # the engine's state, allocated once and written in place
            t_enc = -(-(self._window // fe.hop_length) // 2)  # conv2 halves the frames
            enc1 = torch.zeros(1, t_enc, wcfg.d_model, dtype=DTYPES[wcfg.dtype], device=dev)
            unit = self.model.init_cache(1, enc1, self.max_len, self._layout)
            self._caches = _rows_of_zeros(unit, S)
            self._enc_all = torch.zeros((S, *enc1.shape[1:]), dtype=enc1.dtype, device=dev)
            self._tokens = fresh.repeat(S, 1)
            self._pos = torch.zeros(S, dtype=torch.long, device=dev)
            self._done = torch.ones(S, dtype=torch.bool, device=dev)  # empty lanes are idle
        self._slot_req: List[Optional[_Request]] = [None] * S
        self._queue: List[_Request] = []
        self._results: Dict[int, _Request] = {}
        self._next_rid = 0
        self.stats = ServingStats()
        # the captured step: its kernel launches by counter name (counted
        # once, at capture), the replays made, and the seconds the warm-up
        # and capture took
        self.step_launches: Dict[str, int] = {}
        self.replays = 0
        self.capture_s = 0.0
        self._graph = None
        if dev.type == "cuda" and graph:
            # warming steps idle lanes only, which admission overwrites
            with torch.no_grad():
                cap = CapturedStep(self._step)
            self._graph, self.step_launches, self.capture_s = cap, cap.launches, cap.capture_s

    # ------------------------------------------------------------- public API
    def submit(self, audio, sample_rate: Optional[int] = None, admit: bool = True) -> int:
        """Queue one utterance (a path or a 1-D array at the frontend rate,
        at most one model window: transcribe() chunks longer ones) and,
        with `admit`, admit it at once if a lane is free; otherwise the next
        step() admits every queued request in one wave. -> request id."""
        fe = self.cfg.frontend
        wavs = self.bundle._collect_audio(audio, sample_rate)
        if len(wavs) != 1:
            raise ValueError("submit() takes exactly one utterance")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(rid=rid, wav=features.pad_or_trim(wavs[0], fe),
                                    submitted_at=time.monotonic(),
                                    wav_len=min(len(wavs[0]), self._window)))
        if admit:
            self._fill_free_slots()
        return rid

    @property
    def in_flight(self) -> int:
        """Requests in lanes or still queued (not yet harvested)."""
        return sum(r is not None for r in self._slot_req) + len(self._queue)

    def step(self) -> List[_Request]:
        """One serving tick: admit queued requests into free lanes, run one
        dispatch (steps_per_dispatch decode steps), harvest the finished
        lanes. -> the requests completed on this tick (.rid, .text, .ids,
        .timed, and their submit / start / finish times)."""
        self._fill_free_slots()
        if any(r is not None for r in self._slot_req):
            self._dispatch_and_harvest()
        done = list(self._results.values())
        self._results.clear()
        return done

    def drain(self) -> Dict[int, str]:
        """Decode until every queued and in-flight request is done -> {rid:
        text} of everything completed since the last step() or drain()."""
        out = {r.rid: r.text for r in self.step()}
        while self._queue or any(r is not None for r in self._slot_req):
            for req in self.step():
                out[req.rid] = req.text
        return out

    def transcribe(self, audios: Sequence, sample_rate=None) -> List[str]:
        """Order-preserving: every utterance split into model windows (as
        bundle.transcribe chunks long recordings), queued, drained and
        re-joined."""
        raw = self.bundle._collect_audio(audios, sample_rate)
        rids: List[List[int]] = []
        for a in raw:
            rids.append([self.submit(a[s : s + self._window], admit=False)
                         for s in range(0, max(len(a), 1), self._window)])
        texts = self.drain()
        return ["".join(texts[rid] for rid in group) for group in rids]

    # ---------------------------------------------------------------- internals
    def _state(self) -> List[torch.Tensor]:
        """Every state tensor (the graph reads and writes these addresses)."""
        return [self._tokens, self._pos, self._done, self._enc_all, *_leaves(self._caches)]

    @torch.no_grad()
    def _fill_free_slots(self) -> None:
        """Admit queued requests into free lanes, the whole wave at once."""
        free = [s for s in range(self.slots) if self._slot_req[s] is None]
        take = min(len(free), len(self._queue))
        if take == 0:
            return
        admitted = [(free[i], self._queue.pop(0)) for i in range(take)]
        dev = self.device
        lanes = torch.tensor([s for s, _ in admitted], dtype=torch.long, device=dev)
        wav = torch.from_numpy(np.stack([r.wav for _, r in admitted])).to(dev)
        enc = self.model.encode(features.featurize_batch(wav, self.cfg.frontend))
        unit = self.model.init_cache(take, enc, self.max_len, self._layout)
        for big, small in zip(_leaves(self._caches), _leaves(unit)):
            big.index_copy_(0, lanes, small)
        self._enc_all.index_copy_(0, lanes, enc)
        self._tokens.index_copy_(0, lanes, self._fresh_row.expand(take, -1))
        self._pos.index_fill_(0, lanes, 0)
        self._done.index_fill_(0, lanes, False)
        self.stats.waves += 1
        now = time.monotonic()
        for s, req in admitted:
            req.started_at = now
            self._slot_req[s] = req

    def _step(self) -> None:
        """One decode step of every lane, in place on the state (the JAX
        engine's loop body, ``greedy_step`` at each lane's position): prompt
        tokens are forced, finished lanes write EOT (nothing past the row's
        end) and stay at their position."""
        greedy_step(self.model, self._tokens, self._pos, self._done, self._enc_all,
                    self._caches, None, self._P, self.max_len, self.eot, self._always,
                    self._begin)

    @torch.no_grad()
    def _dispatch(self) -> None:
        """steps_per_dispatch decode steps: graph replays on the card, the
        eager step on the CPU or with graph=False."""
        for _ in range(self.steps_per_dispatch):
            if self._graph is None:
                self._step()
            else:
                self._graph.replay()
                self.replays += 1

    def _dispatch_and_harvest(self) -> None:
        self._dispatch()
        self.stats.dispatches += 1
        self.stats.decode_steps += self.steps_per_dispatch
        # ONE device-to-host copy of done and the whole token pool
        with torch.no_grad():
            host = torch.cat([self._done[:, None].long(), self._tokens], 1).cpu().numpy()
        done, toks = host[:, 0].astype(bool), host[:, 1:]
        now = time.monotonic()
        for s in range(self.slots):
            req = self._slot_req[s]
            if not done[s] or req is None:
                continue
            gen = toks[s, self._P :]
            eots = np.nonzero(gen == self.eot)[0]
            ids = gen[: int(eots[0]) if len(eots) else len(gen)]
            req.ids = [int(i) for i in ids]
            req.text = self.bundle.tokenizer.decode(req.ids)
            if self.timestamps and len(ids):
                req.timed = self._align_request(req, ids)
            req.finished_at = now
            self.stats.completed += 1
            self.stats.latencies_s.append(now - req.submitted_at)
            self._results[req.rid] = req
            self._slot_req[s] = None

    def _align_request(self, req: _Request, ids: np.ndarray) -> list:
        """Per-token spans of one finished request by the cross-attention
        DTW of bundle.transcribe_timed, equal to it for a one-window
        utterance."""
        from ..decode.align import whisper_token_spans

        fe = self.cfg.frontend
        with torch.no_grad():
            mel = features.featurize_batch(torch.from_numpy(req.wav[None]).to(self.device), fe)
        frame_s = fe.hop_length * 2 / fe.sample_rate
        valid = np.asarray([max(req.wav_len // (fe.hop_length * 2), 1)], np.int64)
        spans = whisper_token_spans(self.model, mel, ids[None].astype(np.int64),
                                    np.asarray([len(ids)]), self.prompt, self.eot, valid)[0]
        tok = self.bundle.tokenizer
        return [{"token": tok.decode([int(t)]), "start": round(f0 * frame_s, 3),
                 "end": round(f1 * frame_s, 3)}
                for t, (f0, f1) in zip(ids, spans)]
