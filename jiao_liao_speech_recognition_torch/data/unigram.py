"""SentencePiece-style unigram tokenizer, the port's own copy of the JAX
package's ``data/unigram.py`` (which cannot be imported without jax).

* ``encode``: the Viterbi segmentation, argmax over segmentations of the
  summed piece log-probabilities, a left-to-right DP with a max-piece-length
  scan (sentencepiece's inference algorithm); characters outside the vocab
  become unk.
* ``train``: seed candidates from frequent substrings, then EM: the E-step
  takes expected piece counts by forward-backward over each sentence's
  segmentation lattice, the M-step re-estimates the log-probabilities, and
  a geometric pruning keeps the pieces of highest expected count until the
  target vocab size.
* ``load`` / ``save``: this module's JSON (``{"type": "unigram", "pieces",
  "logprobs"}``, the ``vocab.json`` of a bundle) or the TSV
  ``piece<TAB>logprob`` of ``spm_export_vocab`` (``save_sp_vocab``).

Ids as CharTokenizer's: 0 = CTC blank, 1 = unk, pieces from 2. Every float
is a Python float, summed in the JAX module's order, so both packages train
the same pieces with the same scores.
"""

from __future__ import annotations

import json
import math
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

BLANK = "<blank>"
UNK = "<unk>"
UNK_PENALTY = -16.0  # the score of an unknown character, below any piece


def _log_add(a: float, b: float) -> float:
    """log(exp(a) + exp(b)) with a = -inf as the empty sum."""
    if a == -math.inf:
        return b
    return max(a, b) + math.log1p(math.exp(-abs(a - b)))


class UnigramTokenizer:
    """Unigram-LM subword tokenizer with Viterbi segmentation."""

    def __init__(self, pieces: Sequence[str], logprobs: Sequence[float]):
        if len(pieces) != len(logprobs):
            raise ValueError("pieces and logprobs must align")
        if list(pieces[:2]) != [BLANK, UNK]:
            pieces = [BLANK, UNK] + list(pieces)
            logprobs = [0.0, UNK_PENALTY] + list(logprobs)
        self.vocab: List[str] = list(pieces)
        self.logprobs: List[float] = [float(x) for x in logprobs]
        self.to_id: Dict[str, int] = {p: i for i, p in enumerate(self.vocab)}
        self.max_len = max((len(p) for p in self.vocab[2:]), default=1)

    # -- training ------------------------------------------------------------
    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int = 1024, max_piece_len: int = 4,
              em_iters: int = 4, seed_factor: int = 4) -> "UnigramTokenizer":
        """EM-train a vocab of at most `vocab_size` ids on `texts`
        (whitespace removed, as CharTokenizer does for Mandarin)."""
        sents = [s for s in ("".join(t.split()) for t in texts) if s]
        if not sents:
            return cls([BLANK, UNK], [0.0, UNK_PENALTY])
        chars = sorted({c for s in sents for c in s})
        # candidates: every substring of 2..max_piece_len characters, ranked
        # by count x length; single characters are always kept
        sub_counts: Counter = Counter()
        for s in sents:
            n = len(s)
            for i in range(n):
                for ln in range(2, min(max_piece_len, n - i) + 1):
                    sub_counts[s[i:i + ln]] += 1
        n_multi = max(vocab_size * seed_factor - len(chars), 0)
        ranked = sorted(sub_counts.items(), key=lambda kv: (-kv[1] * len(kv[0]), kv[0]))
        seeds = [p for p, c in ranked[:n_multi] if c >= 2]
        total0 = float(sum(len(s) for s in sents))
        logp = {p: math.log((sub_counts.get(p, 1) * len(p) + 1) / (2 * total0))
                for p in list(chars) + seeds}
        target_multi = max(vocab_size - 2 - len(chars), 0)
        for it in range(em_iters):
            counts = cls._e_step(sents, logp, max_piece_len)
            total = sum(counts.values()) or 1.0
            logp = {p: math.log(max(counts.get(p, 0.0), 1e-12) / total) for p in logp}
            multi = [p for p in logp if len(p) > 1]
            if len(multi) > target_multi:
                last = it == em_iters - 1
                keep_n = target_multi if last else max(target_multi, int(len(multi) * 0.6))
                kept = set(sorted(multi, key=lambda p: -counts.get(p, 0.0))[:keep_n])
                logp = {p: lp for p, lp in logp.items() if len(p) == 1 or p in kept}
        final = sorted(logp)
        return cls([BLANK, UNK] + final, [0.0, UNK_PENALTY] + [logp[p] for p in final])

    @staticmethod
    def _e_step(sents: List[str], logp: Dict[str, float], max_len: int) -> Dict[str, float]:
        """Expected piece counts: forward-backward in the log domain over
        each sentence's lattice (an unknown character is an unk span, so
        every position is reachable)."""
        counts: Dict[str, float] = defaultdict(float)
        for s in sents:
            n = len(s)
            alpha = [-math.inf] * (n + 1)
            alpha[0] = 0.0
            spans: List[List[Tuple[int, str, float]]] = [[] for _ in range(n + 1)]
            for i in range(n):
                for ln in range(1, min(max_len, n - i) + 1):
                    p = s[i:i + ln]
                    lp = logp.get(p)
                    if lp is None:
                        if ln > 1:
                            continue
                        lp = UNK_PENALTY
                    spans[i + ln].append((i, p, lp))
                    alpha[i + ln] = _log_add(alpha[i + ln], alpha[i] + lp)
            z = alpha[n]
            if z == -math.inf:
                continue
            beta = [-math.inf] * (n + 1)
            beta[n] = 0.0
            for j in range(n, 0, -1):
                if beta[j] == -math.inf:
                    continue
                for i, _, lp in spans[j]:
                    beta[i] = _log_add(beta[i], beta[j] + lp)
            for j in range(1, n + 1):
                for i, p, lp in spans[j]:
                    if alpha[i] == -math.inf or beta[j] == -math.inf:
                        continue
                    gamma = alpha[i] + lp + beta[j] - z
                    if gamma > -30.0 and p in logp:
                        counts[p] += math.exp(gamma)
        return counts

    # -- files ---------------------------------------------------------------
    @classmethod
    def load(cls, path: str | Path) -> "UnigramTokenizer":
        """This module's JSON, or the TSV ``piece<TAB>logprob`` dump."""
        text = Path(path).read_text(encoding="utf-8")
        if text.lstrip().startswith("{"):
            obj = json.loads(text)
            return cls(obj["pieces"], obj["logprobs"])
        pieces, logprobs = [], []
        for line in text.splitlines():
            if not line.strip():
                continue
            piece, _, lp = line.partition("\t")
            pieces.append(piece)
            logprobs.append(float(lp) if lp else UNK_PENALTY)
        return cls(pieces, logprobs)

    def save(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"type": "unigram", "pieces": self.vocab, "logprobs": self.logprobs},
                      fh, ensure_ascii=False)

    def save_sp_vocab(self, path: str | Path) -> None:
        """The ``spm_export_vocab`` TSV."""
        with open(path, "w", encoding="utf-8") as fh:
            for p, lp in zip(self.vocab, self.logprobs):
                fh.write(f"{p}\t{lp:.6f}\n")

    # -- codec ---------------------------------------------------------------
    @property
    def blank_id(self) -> int:
        return 0

    @property
    def unk_id(self) -> int:
        return 1

    def __len__(self) -> int:
        return len(self.vocab)

    def encode(self, text: str) -> List[int]:
        """Viterbi best segmentation -> piece ids (unk for novel characters)."""
        s = "".join(text.split())
        n = len(s)
        best = [-math.inf] * (n + 1)
        back: List[Tuple[int, int]] = [(-1, -1)] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == -math.inf:
                continue
            for ln in range(1, min(self.max_len, n - i) + 1):
                pid = self.to_id.get(s[i:i + ln])
                if pid is None or pid < 2:
                    if ln > 1:
                        continue
                    pid, lp = 1, UNK_PENALTY
                else:
                    lp = self.logprobs[pid]
                if best[i] + lp > best[i + ln]:
                    best[i + ln] = best[i] + lp
                    back[i + ln] = (i, pid)
        ids: List[int] = []
        j = n
        while j > 0:
            j, pid = back[j]
            ids.append(pid)
        return ids[::-1]

    def decode(self, ids: Sequence[int]) -> str:
        out = "".join(self.vocab[i] for i in ids if 2 <= i < len(self.vocab))
        return out.replace("▁", " ").strip()
