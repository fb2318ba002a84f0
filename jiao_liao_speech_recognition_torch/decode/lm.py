"""Character n-gram LM for shallow fusion, the twin of the JAX package's
``decode/lm.py`` (numpy only; the JAX module sits in a package whose
``__init__`` imports jax, so the port keeps its own copy).

Stupid-backoff scoring over tokenizer ids (BOS is id -1 inside), the dense
[V, V] bigram log-prob matrix the AR beam adds to its per-step log-probs
(``decode/whisper_generate.py::load_bigram_matrix``), and the same ``.npz``
file both packages write and read: ``grams`` int32 [N, order] padded with
-2, ``counts`` int64 [N], ``meta`` the JSON of order and vocab_size.
``cli train-lm`` trains one over manifest transcripts.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

BACKOFF = 0.4  # stupid-backoff factor (Brants et al., 2007)


class NGramCharLM:
    """Character n-gram LM with stupid-backoff scoring; ``counts`` holds
    every 1..order gram, so context counts are the (n-1)-gram entries."""

    def __init__(self, order: int, vocab_size: int,
                 counts: Optional[Dict[Tuple[int, ...], int]] = None):
        if order < 1:
            raise ValueError(f"order must be >= 1, got {order}")
        self.order = order
        self.vocab_size = vocab_size
        self.counts: Dict[Tuple[int, ...], int] = counts or {}
        self.total = sum(c for k, c in self.counts.items() if len(k) == 1)

    @classmethod
    def train(cls, id_seqs: Iterable[Sequence[int]], order: int, vocab_size: int
              ) -> "NGramCharLM":
        counts: Dict[Tuple[int, ...], int] = {}
        for seq in id_seqs:
            toks = [-1] * (order - 1) + [int(t) for t in seq]
            for i in range(order - 1, len(toks)):
                for n in range(1, order + 1):
                    if i - n + 1 < 0:
                        break
                    g = tuple(toks[i - n + 1: i + 1])
                    counts[g] = counts.get(g, 0) + 1
        return cls(order, vocab_size, counts)

    @classmethod
    def train_from_texts(cls, texts: Iterable[str], tokenizer, order: int = 3
                         ) -> "NGramCharLM":
        return cls.train((tokenizer.encode(t) for t in texts), order, len(tokenizer))

    def logp(self, context: Sequence[int], tok: int) -> float:
        """Stupid-backoff log-prob of `tok` given up to order-1 context ids;
        an unseen unigram takes the add-one floor over the vocabulary."""
        ctx = tuple(int(c) for c in context)[-(self.order - 1):] if self.order > 1 else ()
        factor = 0.0
        while True:
            denom = self.counts.get(ctx, 0) if ctx else self.total
            num = self.counts.get(ctx + (int(tok),), 0)
            if num > 0 and denom > 0:
                return factor + float(np.log(num / denom))
            if not ctx:
                return factor + float(
                    np.log((num + 1.0) / (max(self.total, 1) + self.vocab_size)))
            ctx = ctx[1:]
            factor += float(np.log(BACKOFF))

    def score_sequence(self, ids: Sequence[int]) -> float:
        ctx: Tuple[int, ...] = (-1,) * (self.order - 1)
        total = 0.0
        for t in ids:
            total += self.logp(ctx, t)
            ctx = (ctx + (int(t),))[-(self.order - 1):] if self.order > 1 else ()
        return total

    def bigram_log_matrix(self) -> np.ndarray:
        """Dense f32 [V, V] log P(next | prev): seen pairs their bigram
        estimate, the rest the unigram (with its floor) times BACKOFF."""
        V = self.vocab_size
        uni = np.array([self.logp((), v) for v in range(V)], np.float32)
        mat = np.tile(np.log(BACKOFF) + uni[None, :], (V, 1)).astype(np.float32)
        for g, c in self.counts.items():
            if len(g) == 2 and 0 <= g[0] < V and 0 <= g[1] < V:
                denom = self.counts.get((g[0],), 0)
                if denom > 0:
                    mat[g[0], g[1]] = np.log(c / denom)
        return mat

    def save(self, path) -> None:
        keys = sorted(self.counts)
        flat = np.full((len(keys), self.order), -2, np.int32)
        vals = np.zeros(len(keys), np.int64)
        for i, k in enumerate(keys):
            flat[i, : len(k)] = k
            vals[i] = self.counts[k]
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(path, grams=flat, counts=vals,
                            meta=json.dumps({"order": self.order, "vocab_size": self.vocab_size}))

    @classmethod
    def load(cls, path) -> "NGramCharLM":
        with np.load(path, allow_pickle=False) as d:
            meta = json.loads(str(d["meta"]))
            counts = {tuple(int(t) for t in row if t != -2): int(c)
                      for row, c in zip(d["grams"], d["counts"])}
        return cls(meta["order"], meta["vocab_size"], counts)
