"""Evaluation layer of the PyTorch port: CER / WER (metrics.py) and the
RTFx harness (rtfx.py)."""

from .metrics import (  # noqa: F401
    cer,
    corpus_cer,
    corpus_wer,
    edit_distance,
    normalize_text,
    segment_words,
    wer,
)
