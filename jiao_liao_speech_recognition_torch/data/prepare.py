"""Corpus preparation, the twin of the JAX package's ``data/prepare.py``:
recordings + transcript tables -> manifest rows {audio, text, duration,
dialect}, a duration filter and a seeded train/dev/test split. Durations
come from the WAV headers, without decoding."""

from __future__ import annotations

import csv
import wave
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from ..evals.metrics import normalize_text
from .manifest import Manifest, ManifestRow, write_manifest


def wav_duration(path: str | Path) -> float:
    """Duration in seconds from the WAV header (no decode)."""
    with wave.open(str(path), "rb") as wf:
        return wf.getnframes() / float(wf.getframerate())


def from_transcript_table(
    table_path: str | Path,
    audio_root: str | Path = "",
    dialect: str = "",
    delimiter: str = "\t",
    normalize: bool = False,
) -> Manifest:
    """A manifest from a TSV/CSV of (audio_path, transcript) rows; a missing
    audio file gets duration 0 (the duration filter then drops it)."""
    rows: List[ManifestRow] = []
    root = Path(audio_root)
    with open(table_path, encoding="utf-8") as fh:
        for rec in csv.reader(fh, delimiter=delimiter):
            if len(rec) < 2:
                continue
            audio = root / rec[0]
            text = normalize_text(rec[1]) if normalize else rec[1].strip()
            dur = wav_duration(audio) if audio.exists() else 0.0
            rows.append(ManifestRow(str(audio), text, dur, dialect))
    return Manifest(rows)


def from_directory(
    audio_dir: str | Path,
    transcripts: Dict[str, str],
    dialect: str = "",
    suffix: str = ".wav",
) -> Manifest:
    """Pair every audio file under `audio_dir` with transcripts[stem]."""
    rows: List[ManifestRow] = []
    for p in sorted(Path(audio_dir).rglob(f"*{suffix}")):
        text = transcripts.get(p.stem)
        if text is None:
            continue
        rows.append(ManifestRow(str(p), text, wav_duration(p), dialect))
    return Manifest(rows)


def split_manifest(
    manifest: Manifest,
    dev_fraction: float = 0.05,
    test_fraction: float = 0.05,
    seed: int = 0,
) -> Tuple[Manifest, Manifest, Manifest]:
    """Deterministic train/dev/test split (``RandomState(seed)``'s
    permutation); dev and test hold at least one row each."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(manifest))
    n_dev = max(int(len(idx) * dev_fraction), 1)
    n_test = max(int(len(idx) * test_fraction), 1)
    dev = [manifest.rows[i] for i in idx[:n_dev]]
    test = [manifest.rows[i] for i in idx[n_dev : n_dev + n_test]]
    train = [manifest.rows[i] for i in idx[n_dev + n_test :]]
    return Manifest(train), Manifest(dev), Manifest(test)


def prepare_corpus(
    table_path: str | Path,
    out_dir: str | Path,
    audio_root: str | Path = "",
    dialect: str = "",
    min_seconds: float = 0.3,
    max_seconds: float = 30.0,
    dev_fraction: float = 0.05,
    test_fraction: float = 0.05,
    seed: int = 0,
) -> Dict[str, str]:
    """Table -> duration filter -> split -> ``<out_dir>/<dialect>_{train,
    dev,test}.jsonl`` -> {"train", "dev", "test"}: their paths."""
    m = from_transcript_table(table_path, audio_root, dialect)
    m = m.filter_duration(min_seconds, max_seconds)
    train, dev, test = split_manifest(m, dev_fraction, test_fraction, seed)
    out = Path(out_dir)
    paths = {}
    for name, part in [("train", train), ("dev", dev), ("test", test)]:
        p = out / f"{dialect or 'corpus'}_{name}.jsonl"
        write_manifest(part.rows, p)
        paths[name] = str(p)
    return paths
