"""Corpus CER / WER, the twin of the JAX package's ``evals/metrics.py``
(which the port may not import): the same normalization, the same jieba
segmentation with the same character/Latin-run fallback, and plain
Levenshtein distance (``edit_ops`` splits it into hits, substitutions,
deletions and insertions along JAX's backtrace). Corpus error rate =
sum(edit distances) / sum(reference lengths), as jiwer computes it on
lists; ``cer`` / ``wer`` score one utterance (an empty reference scores 0,
or inf against a non-empty hypothesis)."""

from __future__ import annotations

import re
import unicodedata
from functools import lru_cache
from typing import Iterable, List, Sequence, Tuple

import numpy as np

_PUNCT_RE = re.compile(
    r"[\s!\"#$%&'()*+,\-./:;<=>?@\[\\\]^_`{|}~"
    r"。，、；：？！「」『』（）《》〈〉【】〔〕…—～·‘’“”　]+"
)


def normalize_text(text: str, *, keep_spaces: bool = False) -> str:
    """NFKC-fold, lowercase Latin, strip punctuation and whitespace."""
    text = unicodedata.normalize("NFKC", text).lower()
    text = _PUNCT_RE.sub(" " if keep_spaces else "", text)
    if keep_spaces:
        text = re.sub(r"\s+", " ", text).strip()
    return text


@lru_cache(maxsize=1)
def _jieba():
    try:
        import jieba

        jieba.setLogLevel(60)
        return jieba
    except Exception:
        return None


def segment_words(text: str) -> List[str]:
    """jieba words when jieba is installed, else characters and Latin runs."""
    jb = _jieba()
    if jb is not None:
        return [w for w in jb.cut(text) if w.strip()]
    return [t for t in re.findall(r"[a-z0-9]+|[^a-z0-9]", text) if t.strip()]


def _encode_pair(ref: Sequence, hyp: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """Two token sequences on one integer alphabet."""
    vocab: dict = {}
    return tuple(np.array([vocab.setdefault(t, len(vocab)) for t in seq], np.int32)
                 for seq in (ref, hyp))


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance, two-row DP vectorised over the hypothesis."""
    r, h = _encode_pair(ref, hyp)
    if len(r) == 0:
        return len(h)
    if len(h) == 0:
        return len(r)
    idx = np.arange(len(h) + 1, dtype=np.int32)
    prev = idx.copy()
    for i in range(1, len(r) + 1):
        t = np.minimum(prev[:-1] + (h != r[i - 1]), prev[1:] + 1)
        c = np.concatenate((np.array([i], dtype=np.int32), t))
        prev = idx + np.minimum.accumulate(c - idx)
    return int(prev[-1])


def edit_ops(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """(hits, substitutions, deletions, insertions) of an optimal unit-cost
    alignment: the full DP table, then the JAX function's backtrace from
    the end (a diagonal move first, then a deletion, else an insertion), so
    ties split the same way; S + D + I is the edit distance."""
    r, h = _encode_pair(ref, hyp)
    n, m = len(r), len(h)
    if n == 0:
        return 0, 0, 0, m
    if m == 0:
        return 0, 0, n, 0
    dp = np.zeros((n + 1, m + 1), dtype=np.int32)
    dp[0, :] = np.arange(m + 1)
    dp[:, 0] = np.arange(n + 1)
    idx = np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        t = np.minimum(dp[i - 1, :-1] + (h != r[i - 1]), dp[i - 1, 1:] + 1)
        c = np.concatenate((np.array([i], dtype=np.int32), t))
        dp[i] = idx + np.minimum.accumulate(c - idx)  # the insertion chain in closed form
    i, j = n, m
    hits = subs = dels = ins = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (r[i - 1] != h[j - 1]):
            if r[i - 1] == h[j - 1]:
                hits += 1
            else:
                subs += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return hits, subs, dels, ins


def _rate(ref_tokens: Sequence, hyp_tokens: Sequence) -> float:
    n = len(ref_tokens)
    if n == 0:
        return 0.0 if len(hyp_tokens) == 0 else float("inf")
    return edit_distance(ref_tokens, hyp_tokens) / n


def cer(reference: str, hypothesis: str, *, normalize: bool = True) -> float:
    """One utterance's character error rate."""
    if normalize:
        reference, hypothesis = normalize_text(reference), normalize_text(hypothesis)
    return _rate(list(reference), list(hypothesis))


def wer(reference: str, hypothesis: str, *, normalize: bool = True) -> float:
    """One utterance's word error rate over segmented words."""
    if normalize:
        reference, hypothesis = normalize_text(reference), normalize_text(hypothesis)
    return _rate(segment_words(reference), segment_words(hypothesis))


def corpus_cer(references: Iterable[str], hypotheses: Iterable[str]) -> float:
    errs = total = 0
    for ref, hyp in zip(references, hypotheses):
        ref_n, hyp_n = normalize_text(ref), normalize_text(hyp)
        errs += edit_distance(list(ref_n), list(hyp_n))
        total += len(ref_n)
    return errs / max(total, 1)


def corpus_wer(references: Iterable[str], hypotheses: Iterable[str]) -> float:
    errs = total = 0
    for ref, hyp in zip(references, hypotheses):
        ref_w = segment_words(normalize_text(ref))
        hyp_w = segment_words(normalize_text(hyp))
        errs += edit_distance(ref_w, hyp_w)
        total += len(ref_w)
    return errs / max(total, 1)
