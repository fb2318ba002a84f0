"""Host batches: manifest rows -> padded, bucketed batches (the twin of the
JAX package's ``data/pipeline.py``).

The epoch plan is the JAX package's, draw for draw: rows are shuffled with
``numpy.random.RandomState(shuffle_seed + epoch)``, grouped by duration
bucket, cut into fixed-size batches and the batch order shuffled, so both
packages feed the same rows in the same order. The iterator state is
(epoch, cursor); ``state_dict`` / ``load_state_dict`` make resume exact.

Several processes (parallel/multihost.py): every process builds the same
plan of global batches and collates only its rows [p B / n, (p + 1) B / n)
of each, so the state is global and resume is exact on any process count;
a batch the count does not divide (a tiny corpus's partial batch) is
collated whole by every process.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..frontend.audio_io import read_audio
from ..frontend.resample import resample
from ..utils.config import DataConfig
from .manifest import Manifest, ManifestRow
from .tokenizer import CharTokenizer


@dataclass
class Batch:
    """Host-side padded batch: this process's rows of a global batch of
    ``global_rows`` rows (all of them with one process)."""

    audio: np.ndarray  # [B, samples] float32 (or int16 wire format)
    audio_lengths: np.ndarray  # [B] int32 valid samples
    labels: np.ndarray  # [B, S] int32
    label_lengths: np.ndarray  # [B] int32
    texts: List[str]
    bucket_seconds: float
    global_rows: int = 0


def _bucket_for(duration: float, boundaries: Sequence[float]) -> float:
    i = bisect.bisect_left(list(boundaries), duration)
    return boundaries[min(i, len(boundaries) - 1)]


class BatchIterator:
    """Deterministic, resumable batch iterator; `process_index` /
    `process_count` default to the process group's (parallel/multihost.py).
    On a mesh with a model axis the rows are each (data, fsdp) rank's, not
    each process's: ``train_loop`` passes that rank and count."""

    def __init__(
        self,
        manifest: Manifest,
        tokenizer: CharTokenizer,
        cfg: DataConfig,
        sample_rate: int = 16000,
        drop_last: bool = True,
        shuffle: bool = True,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.rows = list(
            manifest.filter_duration(cfg.min_audio_seconds, cfg.max_audio_seconds)
        )
        if not self.rows:
            raise ValueError("manifest is empty after duration filtering")
        if cfg.transfer_dtype not in ("float32", "int16"):
            raise ValueError(
                f"transfer_dtype must be 'float32' or 'int16', got {cfg.transfer_dtype!r}"
            )
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.sample_rate = sample_rate
        self.drop_last = drop_last
        self.shuffle = shuffle
        if process_index is None or process_count is None:
            from ..parallel import multihost

            process_index, process_count = multihost.process_index(), multihost.process_count()
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        if self.process_count > 1 and cfg.batch_size % self.process_count:
            raise ValueError(
                f"batch_size={cfg.batch_size} must divide evenly over "
                f"{self.process_count} processes"
            )
        self.epoch = 0
        self.cursor = 0
        self._plan: Optional[List[List[int]]] = None
        self._plan_epoch = -1

    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "cursor": self.cursor}

    def load_state_dict(self, state: Dict) -> None:
        self.epoch = int(state["epoch"])
        self.cursor = int(state["cursor"])

    def _epoch_plan(self) -> List[List[int]]:
        rng = np.random.RandomState(self.cfg.shuffle_seed + self.epoch)
        order = rng.permutation(len(self.rows)) if self.shuffle else np.arange(len(self.rows))
        by_bucket: Dict[float, List[int]] = {}
        for i in order:
            b = _bucket_for(
                self.rows[i].duration or self.cfg.max_audio_seconds,
                self.cfg.bucket_boundaries_seconds,
            )
            by_bucket.setdefault(b, []).append(int(i))
        batches: List[List[int]] = []
        for b in sorted(by_bucket):
            idxs = by_bucket[b]
            for k in range(0, len(idxs), self.cfg.batch_size):
                chunk = idxs[k : k + self.cfg.batch_size]
                if len(chunk) == self.cfg.batch_size or not self.drop_last:
                    batches.append(chunk)
        if not batches:  # tiny corpus: one partial batch
            batches = [list(order[: self.cfg.batch_size])]
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    def _plan_for_epoch(self) -> List[List[int]]:
        if self._plan_epoch != self.epoch:
            self._plan = self._epoch_plan()
            self._plan_epoch = self.epoch
        return self._plan

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        plan = self._plan_for_epoch()
        if self.cursor >= len(plan):
            self.epoch += 1
            self.cursor = 0
            plan = self._plan_for_epoch()
        idxs = plan[self.cursor]
        self.cursor += 1
        rows = [self.rows[i] for i in idxs]
        bucket = max(
            _bucket_for(r.duration or self.cfg.max_audio_seconds,
                        self.cfg.bucket_boundaries_seconds)
            for r in rows
        )
        return self._collate(rows, bucket)

    def _collate(self, rows: List[ManifestRow], bucket_seconds: float) -> Batch:
        samples = int(bucket_seconds * self.sample_rate)
        global_rows = len(rows)
        if self.process_count > 1 and global_rows % self.process_count == 0:
            k = global_rows // self.process_count
            rows = rows[self.process_index * k:(self.process_index + 1) * k]
        B = len(rows)
        int16_wire = self.cfg.transfer_dtype == "int16"
        audio = np.zeros((B, samples), np.int16 if int16_wire else np.float32)
        alen = np.zeros((B,), np.int32)
        labels = np.zeros((B, self.cfg.max_text_len), np.int32)
        llen = np.zeros((B,), np.int32)
        texts = []
        for i, r in enumerate(rows):
            pcm, sr = read_audio(r.audio)
            if sr != self.sample_rate:  # on the host, where the loader runs
                pcm = resample(torch.from_numpy(pcm), sr, self.sample_rate).numpy()
            m = min(len(pcm), samples)
            if int16_wire:
                # exact for 16-bit sources (f32 was i / 32768, so
                # rint(f32 * 32768) == i); at most 1 lsb of quantisation for
                # the others (resampled, 24-bit, float)
                audio[i, :m] = np.clip(np.rint(pcm[:m] * 32768.0), -32768, 32767).astype(np.int16)
            else:
                audio[i, :m] = pcm[:m]
            alen[i] = m
            ids = self.tokenizer.encode(r.text)[: self.cfg.max_text_len]
            labels[i, : len(ids)] = ids
            llen[i] = len(ids)
            texts.append(r.text)
        return Batch(audio, alen, labels, llen, texts, bucket_seconds, global_rows)


class PrefetchIterator:
    """Background-thread prefetch around a BatchIterator. The saved state is
    that after the last batch handed out (not the last one prefetched), so
    a restored run replays the batches that were never consumed."""

    def __init__(self, inner: BatchIterator, depth: int = 2):
        self.inner = inner
        self.depth = depth
        self._queue = None
        self._thread = None
        self._stop = None
        self._consumed_state: Optional[Dict] = None

    def _ensure_started(self):
        if self._thread is not None:
            return
        import queue
        import threading

        self._queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()

        def worker():
            try:
                while not self._stop.is_set():
                    batch = next(self.inner)
                    self._queue.put((batch, self.inner.state_dict()))
            except BaseException as e:  # hand the error to the consumer
                self._queue.put((None, e))

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        self._ensure_started()
        batch, state = self._queue.get()
        if batch is None:
            raise RuntimeError("prefetch worker died") from state
        self._consumed_state = state
        return batch

    def state_dict(self) -> Dict:
        return self._consumed_state or self.inner.state_dict()

    def load_state_dict(self, state: Dict) -> None:
        if self._thread is not None:
            raise RuntimeError("load_state_dict after iteration started")
        self.inner.load_state_dict(state)

    def close(self) -> None:
        """Stop the worker (it may sit blocked on a full queue: drain one)."""
        if self._thread is None:
            return
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._queue.get(timeout=0.1)
            except Exception:
                pass
            self._thread.join(timeout=0.1)


def make_batches(manifest: Manifest, tokenizer: CharTokenizer, cfg: DataConfig,
                 num_batches: int, **kw) -> List[Batch]:
    """A fixed number of batches (tests, tiny corpora)."""
    it = BatchIterator(manifest, tokenizer, cfg, **kw)
    return [next(it) for _ in range(num_batches)]


def mix_manifests(manifests: Dict[str, Manifest], weights: Optional[Dict[str, float]] = None,
                  seed: int = 0) -> Manifest:
    """Weighted multi-dialect mixture: ``len(manifests)`` times the largest
    corpus's size in draws with replacement, a corpus by weight and then a
    row, from ``RandomState(seed)`` over the sorted names (the JAX
    package's draws, row for row)."""
    names = sorted(manifests)
    if weights is None:
        weights = {n: 1.0 for n in names}
    rng = np.random.RandomState(seed)
    target = max(len(manifests[n]) for n in names)
    probs = np.array([weights.get(n, 1.0) for n in names], np.float64)
    probs /= probs.sum()
    out: List[ManifestRow] = []
    for _ in range(target * len(names)):
        rows = manifests[names[rng.choice(len(names), p=probs)]].rows
        out.append(rows[rng.randint(len(rows))])
    return Manifest(out)
