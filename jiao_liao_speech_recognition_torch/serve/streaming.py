"""Streaming (online) CTC transcription over a sliding window, the PyTorch
twin of the JAX package's ``serve/streaming.py``.

The CTC family's low-latency serving surface, and the joint CTC/attention
family's through its CTC branch (Whisper's is ``serve/engine.py``). Every dispatch has one shape: featurize a W-second
audio window (K1), run the encoder (K2 and K3 a block, or the module path
of attention and K3 for a limited-context model) and take per-frame argmax
ids from the head (K4), once a hop. The ragged, stateful work (the audio
ring, frame-commit accounting, incremental CTC collapse) is integer
bookkeeping on the host.

Commit discipline: the encoder is bidirectional inside the window, so the
newest frames' posteriors still change as right context arrives. A frame
is committed (final) once it has ``lookahead_seconds`` of audio to its
right; newer frames form the mutable ``preview``. Window starts sit on the
encoder-frame grid (multiples of hop_length * subsample_factor samples),
so a global frame index is well defined across windows, and committed ids
stream through the collapse rule of ``decode.ctc.ctc_greedy_collapse``
with the previous frame's id carried across window boundaries.

Latency = hop_seconds + lookahead_seconds + one window step. With the
whole utterance inside one window, finish() gives the offline
``transcribe`` text exactly (same features, same length mask).

``StreamingPool`` batches N streams into one [slots, W] step. With the
device ring (the default) each row's current window lives on the device
and a step sends only the new hop samples and four [slots] integer vectors;
the ring update (a per-row roll, the hop written in, idle rows left as they
are), featurize and encode are one step, which on a card is captured once
as a CUDA graph at construction (warmed on a side stream first) and
replayed by every ``step()``. Its buffers are allocated once and written in
place, so the addresses the graph recorded stay valid; a pool serves the
weights it was made with. ``graph=False`` runs that step eagerly on a card
(on the CPU it always runs eagerly); a capture that fails raises.

A split bundle (``ModelBundle.shard``, a model axis over a process group)
streams as one card's: every rank of a model group runs the whole window
batch through its heads and hidden columns, the blocks' row layers sum
their partials over the group, and the head is whole on every rank, so
each rank's ids and texts are the same. Both classes are then SPMD: every
rank of the group must be fed the same audio and call ``feed`` / ``open``
/ ``step`` / ``finish`` in the same order (as the JAX package's
multi-controller programs are), since each window step holds collectives
that every rank must enter. Every host branch that decides whether a step
runs reads only the streams' sample counts, which are then equal on every
rank. The pool's captured ring step holds the blocks' NCCL all-reduces:
the group must start with ``multihost.initialize(graph_collectives=True)``,
and the side-stream warm-up runs the collectives first, so that NCCL's
communicators exist before the capture. A stand-in group (parallel/tp.py:
ranks played in one process) cannot be captured: the pool refuses one on a
card unless ``graph=False`` asks for the eager step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..frontend import features
from ..parallel.tp import check_capturable
from ..utils.graphs import CapturedStep


@dataclass
class StreamingConfig:
    """Sliding-window parameters.

    window_seconds: audio context the encoder sees a step. More context is
      closer to offline quality and linearly more compute a hop.
    hop_seconds: how often a new window is dispatched; the cadence of
      partial results. A multiple of the encoder-frame stride
      (hop_length * subsample_factor samples, 40 ms for the flagship).
    lookahead_seconds: right context a frame needs before it is committed.
      Smaller is lower latency, larger is committed text closer to offline;
      0 commits every frame as soon as it is computed.
    """

    window_seconds: float = 10.0
    hop_seconds: float = 0.4
    lookahead_seconds: float = 0.64


@dataclass
class StreamingResult:
    """One feed() / finish() / pool step outcome."""

    text: str  # all committed (final) text so far
    new_text: str  # text committed by this call
    preview: str  # unstable tail past the commit point; will change
    committed_frames: int  # encoder frames finalized so far
    # committed trailing silence (seconds of blank frames since the last
    # non-blank commit): the endpointing signal a serving layer finalizes
    # an utterance on once it passes its threshold (e.g. 0.8 s)
    trailing_silence: float = 0.0
    is_final: bool = False


def window_step(bundle):
    """-> step(wav [B, W] f32, mel frames [B] int32) -> (ids [B, T'] int32,
    encoder frames [B]) as numpy: featurize (K1), then the model's
    per-frame CTC argmax ids (``frame_ids``; K4), on the bundle's device."""
    model, fe, dev = bundle.model, bundle.config.frontend, bundle.device

    @torch.no_grad()
    def step(wav: np.ndarray, nframes: np.ndarray):
        feats = features.featurize_batch(torch.from_numpy(wav).to(dev), fe)
        ids, lens = model.frame_ids(feats, torch.from_numpy(nframes).to(dev))
        return ids.cpu().numpy(), lens.cpu().numpy()

    return step


class StreamingTranscriber:
    """Incremental greedy-CTC transcription of one audio stream::

        st = StreamingTranscriber(bundle)
        for pcm in microphone_chunks():      # float32 at the frontend rate
            res = st.feed(pcm)
            print(res.text + res.preview)
        final_text = st.finish().text

    The ctc family, and the joint family's CTC branch (its subsample factor
    and max_frames); Whisper is served by serve/engine.py.
    ``_step`` is the window step (``window_step``); a test may swap it.
    """

    def __init__(self, bundle, stream_cfg: Optional[StreamingConfig] = None,
                 blank_id: Optional[int] = None):
        self.bundle = bundle
        self.cfg = stream_cfg or StreamingConfig()
        config = bundle.config
        fe = config.frontend
        family = config.model_family
        if family not in ("ctc", "joint"):
            raise ValueError(
                f"streaming supports the ctc/joint families, not {family!r}; "
                "whisper serving is serve/engine.py"
            )
        model_cfg = config.ctc_model if family == "ctc" else config.joint
        sub = model_cfg.subsample_factor
        max_frames = model_cfg.max_frames
        self._align = fe.hop_length * sub  # samples an encoder frame
        self._hop_len = fe.hop_length
        sr = fe.sample_rate
        self._W = int(round(self.cfg.window_seconds * sr))
        self._hop = int(round(self.cfg.hop_seconds * sr))
        if self._W % self._align or self._hop % self._align:
            raise ValueError(
                f"window/hop must be multiples of the encoder frame stride "
                f"({self._align} samples = {self._align / sr:.3f} s); got "
                f"window={self._W}, hop={self._hop}"
            )
        if self._W // fe.hop_length > max_frames:
            raise ValueError(
                f"window of {self._W // fe.hop_length} mel frames exceeds the "
                f"model's max_frames={max_frames}"
            )
        self._look = int(np.ceil(self.cfg.lookahead_seconds * sr / self._align))
        if self._W < self._hop + self._look * self._align:
            raise ValueError(
                "window_seconds must cover hop_seconds + lookahead_seconds; "
                f"got window={self._W}, hop={self._hop}, "
                f"lookahead={self._look} frames"
            )
        self.blank_id = config.decode.ctc_blank_id if blank_id is None else blank_id
        self._step = window_step(bundle)

        self._buf = np.zeros(0, np.float32)  # samples [base, base + len)
        self._base = 0  # global sample index of buf[0]
        self._total = 0  # samples received
        self._end = 0  # last processed (hop-aligned) window end
        self._committed = 0  # global encoder frames finalized
        self._prev_id = -1  # last committed frame id (the collapse carry)
        self._tokens: List[int] = []  # committed token ids
        # committed tokens' frame spans [(start, end)) in global encoder
        # frames: decode.ctc.ctc_collapse_with_times's emission rule
        self._spans: List[tuple] = []
        self._last_voice = 0  # the frame after the last committed non-blank
        self._preview_ids: List[int] = []
        self._finished = False

    def feed(self, pcm: np.ndarray) -> StreamingResult:
        """Append audio (float32 / float64 / int16 mono at the frontend
        sample rate) and return the updated partial transcript."""
        if self._finished:
            raise RuntimeError("stream already finished")
        self._append(pcm)
        n_before = len(self._tokens)
        while self._total >= self._end + self._hop:
            self._end += self._hop
            self._run_window(self._end, final=False)
            self._trim()
        return self._result(n_before, final=False)

    def finish(self) -> StreamingResult:
        """Flush: commit every remaining frame and return the final text."""
        if self._finished:
            raise RuntimeError("stream already finished")
        n_before = len(self._tokens)
        if self._total > 0:
            self._run_window(self._total, final=True)
        self._finished = True
        self._preview_ids = []
        return self._result(n_before, final=True)

    @property
    def text(self) -> str:
        return self.bundle.tokenizer.decode(self._tokens)

    @property
    def timed_tokens(self) -> List[dict]:
        """Committed tokens with start / end seconds from the CTC frame
        alignment (transcribe_timed's emission rule)."""
        frame_s = self._align / self.bundle.config.frontend.sample_rate
        tok = self.bundle.tokenizer
        return [{"token": tok.decode([t]), "start": round(s * frame_s, 3),
                 "end": round(e * frame_s, 3)}
                for t, (s, e) in zip(self._tokens, self._spans)]

    @property
    def timed_words(self) -> List[dict]:
        """Committed words with start / end seconds: timed_tokens merged by
        the jieba segmentation WER scores (utils/captions.group_words)."""
        from ..utils.captions import group_words

        return group_words(self.timed_tokens)

    def _append(self, pcm: np.ndarray) -> None:
        """Buffer audio without dispatching (StreamingPool batches the
        dispatches across slots)."""
        pcm = np.asarray(pcm)
        if pcm.dtype == np.int16:
            pcm = pcm.astype(np.float32) / 32768.0
        pcm = np.ascontiguousarray(pcm, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, pcm])
        self._total += len(pcm)

    def _trim(self) -> None:
        # keep a whole window ending at `end`: the next hop's window starts
        # at end + hop - W, but a finish() between hops can start its last
        # window as early as aligned_up(total - W) >= end - W
        keep_from = max(0, self._end - self._W)
        if keep_from > self._base:
            self._buf = self._buf[keep_from - self._base:]
            self._base = keep_from

    def _build_window(self, end: int):
        """-> (wav [W] f32, valid mel frames, e0 global frame offset). The
        window starts on the encoder-frame grid (ceil keeps len <= W)."""
        start = max(0, -(-(end - self._W) // self._align) * self._align)
        seg = self._buf[start - self._base:end - self._base]
        wav = np.zeros(self._W, np.float32)
        wav[:len(seg)] = seg
        return wav, len(seg) // self._hop_len, start // self._align

    def _run_window(self, end: int, final: bool) -> None:
        wav, nfr, e0 = self._build_window(end)
        ids, out_lens = self._step(wav[None], np.asarray([nfr], np.int32))
        self._absorb(np.asarray(ids[0]), int(out_lens[0]), e0, final)

    def _absorb(self, ids: np.ndarray, out_len: int, e0: int, final: bool) -> None:
        """Commit the window's stable frames and refresh the preview."""
        n_glob = e0 + out_len
        cut = n_glob if final else max(self._committed, n_glob - self._look)
        if cut > self._committed:
            new = ids[self._committed - e0:cut - e0]
            prev = self._prev_id
            for k, t in enumerate(new.tolist()):
                g = self._committed + k
                if t != self.blank_id and t != prev:
                    self._tokens.append(t)
                    self._spans.append((g, g + 1))
                elif t != self.blank_id and self._tokens:
                    # t == prev != blank: the run goes on; extend its span
                    self._spans[-1] = (self._spans[-1][0], g + 1)
                if t != self.blank_id:
                    self._last_voice = g + 1
                prev = t
            self._prev_id = prev
            self._committed = cut
        # the unstable tail: collapse goes on from the committed carry
        pv: List[int] = []
        prev = self._prev_id
        for t in ids[cut - e0:n_glob - e0].tolist():
            if t != self.blank_id and t != prev:
                pv.append(t)
            prev = t
        self._preview_ids = pv

    def _result(self, n_before: int, final: bool) -> StreamingResult:
        tok = self.bundle.tokenizer
        frame_s = self._align / self.bundle.config.frontend.sample_rate
        return StreamingResult(
            text=tok.decode(self._tokens),
            new_text=tok.decode(self._tokens[n_before:]),
            preview=tok.decode(self._preview_ids),
            committed_frames=self._committed,
            trailing_silence=round((self._committed - self._last_voice) * frame_s, 3),
            is_final=final,
        )


class StreamingPool:
    """N concurrent streams sharing one batched window step::

        pool = StreamingPool(bundle, slots=32)
        sid = pool.open()
        pool.feed(sid, pcm)                       # buffers only
        for sid, res in pool.step().items():      # one step, every slot
            push_partial(sid, res.text + res.preview)
        final = pool.finish(sid)                  # flush + free the slot

    The slot count is fixed, so every step has one shape; an open slot
    advances by at most one hop a step(); idle rows ride along at one
    encoder frame and their outputs are ignored. Each slot's results are
    StreamingTranscriber's (same commit discipline and collapse carry).

    ``device_ring`` keeps each row's window on the device (see the module
    docstring); without it every step assembles the [slots, W] windows on
    the host. ``finish()`` always takes the host-assembled step. On a card
    the ring step is a CUDA graph unless ``graph=False``; the launch
    counters count its capture, whose launches are kept as
    ``step_launches`` (by counter name) and taken back off the counters,
    and ``replays`` counts its replays. On a split bundle every rank of the
    model group makes the same pool and drives it alike (the module
    docstring).
    """

    def __init__(self, bundle, slots: int = 8, stream_cfg: Optional[StreamingConfig] = None,
                 device_ring: bool = True, graph: bool = True):
        if graph and device_ring:
            check_capturable(bundle.model, bundle.device, "StreamingPool")
        self.bundle = bundle
        self.cfg = stream_cfg or StreamingConfig()
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.slots = int(slots)
        # the validated geometry and the window step; its stream state is unused
        self._proto = StreamingTranscriber(bundle, self.cfg)
        self._active: dict = {}
        self._next_id = 0
        self._device_ring = bool(device_ring)
        self._rows: dict = {}  # sid -> ring row
        self._free_rows = list(range(self.slots))
        self.step_launches: dict = {}
        self.replays = 0
        self.capture_s = 0.0
        self._graph = None
        if self._device_ring:
            self._ring_buffers()
            if self._ring.device.type == "cuda" and graph:
                self._graph = self._capture()

    def open(self) -> int:
        """Claim a slot for a new stream; returns its id."""
        if len(self._active) >= self.slots:
            raise RuntimeError(f"pool full ({self.slots} slots)")
        sid = self._next_id
        self._next_id += 1
        self._active[sid] = StreamingTranscriber(self.bundle, self.cfg)
        row = self._free_rows.pop(0)
        self._rows[sid] = row
        if self._device_ring:
            with torch.no_grad():  # a reused row must not leak the last stream's audio
                self._ring[row].zero_()
        return sid

    def feed(self, sid: int, pcm: np.ndarray) -> None:
        """Buffer audio for a stream. Nothing is dispatched until step()."""
        self._active[sid]._append(pcm)

    def step(self) -> dict:
        """Advance every slot holding at least one hop of unprocessed audio
        by one hop, in one batched step -> {sid: StreamingResult} for the
        slots that advanced."""
        jobs = []
        for sid, st in self._active.items():
            if st._total >= st._end + st._hop:
                st._end += st._hop
                jobs.append((sid, st, st._end, False))
        out = self._dispatch_ring(jobs) if self._device_ring else self._dispatch(jobs)
        for _, st, _, _ in jobs:
            st._trim()
        return out

    def finish(self, sid: int) -> StreamingResult:
        """Flush a stream's remaining frames and release its slot."""
        st = self._active.pop(sid)
        self._free_rows.append(self._rows.pop(sid))
        # drain backlogged hops first: pool feed() only buffers, so a slot
        # finished without step()s may hold more than one window of audio,
        # and the last window alone would skip frames older than total - W
        while st._total >= st._end + st._hop:
            st._end += st._hop
            self._dispatch([(sid, st, st._end, False)])
            st._trim()
        if st._total > 0:
            res = self._dispatch([(sid, st, st._total, True)])[sid]
        else:
            res = st._result(len(st._tokens), final=True)
        st._finished = True
        return res

    def _dispatch(self, jobs) -> dict:
        """The host-assembled step: each job's window built on the host."""
        if not jobs:
            return {}
        proto = self._proto
        wav = np.zeros((self.slots, proto._W), np.float32)
        # idle rows: one encoder frame of silence keeps the length mask
        # non-empty (a fully masked attention row is NaN); outputs ignored
        nfr = np.full((self.slots,), proto._align // proto._hop_len, np.int32)
        e0s = []
        for i, (sid, st, end, final) in enumerate(jobs):
            row, n, e0 = st._build_window(end)
            wav[i] = row
            nfr[i] = max(n, 1)
            e0s.append(e0)
        ids, out_lens = proto._step(wav, nfr)
        results = {}
        for i, (sid, st, end, final) in enumerate(jobs):
            n_before = len(st._tokens)
            st._absorb(np.asarray(ids[i]), int(out_lens[i]), e0s[i], final)
            results[sid] = st._result(n_before, final=final)
        return results

    # --- the device ring --------------------------------------------------

    def _ring_buffers(self) -> None:
        """The ring step's state and inputs, allocated once: ring [slots, W]
        f32 (each row's current window, prefix-valid, what _build_window
        would assemble), the hop samples [slots, hop] f32 and the control
        rows [4, slots] int64 (shift, write offset, advance, mel frames),
        with host staging for the last two (pinned on a card)."""
        proto = self._proto
        B, W, H = self.slots, proto._W, proto._hop
        dev = self.bundle.device
        pin = dev.type == "cuda"
        self._ring = torch.zeros(B, W, device=dev)
        self._chunk = torch.zeros(B, H, device=dev)
        self._ctrl = torch.zeros(4, B, dtype=torch.int64, device=dev)
        self._ctrl[3] = proto._align // proto._hop_len
        self._h_chunk = torch.zeros(B, H, pin_memory=pin)
        self._h_ctrl = torch.zeros(4, B, dtype=torch.int64, pin_memory=pin)
        self._cols = torch.arange(W, device=dev)
        self._hop_cols = torch.arange(H, device=dev)
        self._out = None  # the last ring step's output (the captured step's own on a graph)

    def _ring_step(self) -> torch.Tensor:
        """One ring step, the ring updated in place -> [slots, 1 + T'] int32
        (each row's encoder frames, then its ids): rolled = each row
        circularly shifted left by `shift` (0 while a stream is younger
        than W, then the hop; one gather), the hop written at `write
        offset`, ring = where(advance, written, ring), then featurize and
        the model's per-frame CTC ids, the host path's computation on the same
        window values."""
        ring, W = self._ring, self._ring.shape[1]
        shift, woff, advance, nframes = self._ctrl
        rolled = ring.gather(1, (self._cols[None, :] + shift[:, None]) % W)
        written = rolled.scatter(1, woff[:, None] + self._hop_cols[None, :], self._chunk)
        ring.copy_(torch.where(advance[:, None] > 0, written, ring))
        feats = features.featurize_batch(ring, self.bundle.config.frontend)
        ids, lens = self.bundle.model.frame_ids(feats, nframes)
        return torch.cat([lens[:, None], ids], 1)

    @torch.no_grad()
    def _capture(self) -> CapturedStep:
        """Warm the ring step on a side stream (the kernels' library,
        cuDNN's and cuBLAS's handles, the serving copies, the position
        table, K1's constants, a split model's NCCL communicators), then
        capture it (utils/graphs.py). Every row is idle then, so the ring
        is left as it was."""
        cap = CapturedStep(self._ring_step)
        self._out, self.step_launches, self.capture_s = cap.out, cap.launches, cap.capture_s
        return cap

    def _dispatch_ring(self, jobs) -> dict:
        """Stage the jobs' hop samples and control rows, copy them in (two
        host-to-device copies), run the ring step (a graph replay on a
        card), read the frames and ids back in one copy, absorb."""
        if not jobs:  # equal on every rank of a split model's group (SPMD)
            return {}
        proto = self._proto
        W, H = proto._W, proto._hop
        chunk, ctrl = self._h_chunk.numpy(), self._h_ctrl.numpy()
        chunk.fill(0.0)
        ctrl.fill(0)
        ctrl[3] = proto._align // proto._hop_len
        e0s = {}
        for sid, st, end, _ in jobs:
            r = self._rows[sid]
            chunk[r] = st._buf[end - H - st._base:end - st._base]
            start = max(0, end - W)
            ctrl[0, r] = start - max(0, end - H - W)
            ctrl[1, r] = min(end - H, W - H)
            ctrl[2, r] = 1
            ctrl[3, r] = max((end - start) // proto._hop_len, 1)
            e0s[sid] = start // proto._align
        with torch.no_grad():
            self._chunk.copy_(self._h_chunk, non_blocking=True)
            self._ctrl.copy_(self._h_ctrl, non_blocking=True)
            if self._graph is None:
                self._out = self._ring_step()
            else:
                self._graph.replay()
                self.replays += 1
            out = self._out.cpu().numpy()
        results = {}
        for sid, st, end, final in jobs:
            r = self._rows[sid]
            n_before = len(st._tokens)
            st._absorb(out[r, 1:], int(out[r, 0]), e0s[sid], final)
            results[sid] = st._result(n_before, final=final)
        return results
