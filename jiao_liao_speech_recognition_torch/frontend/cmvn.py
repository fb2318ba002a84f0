"""Global CMVN, the twin of the JAX package's ``frontend/cmvn.py``: corpus
mean/std stats accumulated on the host in f64 (``GlobalCMVN``) from
features made on the device (``compute_corpus_cmvn``: K1 on a card), saved
as an .npz with ``mean``, ``std`` and ``count`` (``cli prepare --cmvn``),
and applied as an affine op."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.config import DataConfig, FrontendConfig


class GlobalCMVN:
    """Running per-mel sums over [B, M, T] feature batches (f64)."""

    def __init__(self, num_mels: int):
        self.n = 0
        self.sum = np.zeros(num_mels, np.float64)
        self.sumsq = np.zeros(num_mels, np.float64)

    def update(self, feats: np.ndarray, frame_lengths: Optional[np.ndarray] = None):
        """Add a batch; with `frame_lengths`, only each row's valid frames."""
        f = np.asarray(feats, np.float64)
        if frame_lengths is None:
            self.sum += f.sum(axis=(0, 2))
            self.sumsq += (f**2).sum(axis=(0, 2))
            self.n += f.shape[0] * f.shape[2]
        else:
            for b in range(f.shape[0]):
                t = int(frame_lengths[b])
                self.sum += f[b, :, :t].sum(axis=1)
                self.sumsq += (f[b, :, :t] ** 2).sum(axis=1)
                self.n += t

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """-> (mean, std) f32, the variance floored at 1e-8."""
        mean = self.sum / max(self.n, 1)
        var = self.sumsq / max(self.n, 1) - mean**2
        return mean.astype(np.float32), np.sqrt(np.maximum(var, 1e-8)).astype(np.float32)

    def save(self, path: str | Path) -> None:
        mean, std = self.finalize()
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, mean=mean, std=std, count=self.n)


def load_cmvn(path: str | Path) -> Tuple[np.ndarray, np.ndarray]:
    d = np.load(path)
    return d["mean"], d["std"]


def apply_global_cmvn(feats: torch.Tensor, mean, std) -> torch.Tensor:
    """[B, M, T] -> (feats - mean) / (std + 1e-8), per mel bin."""
    m = torch.as_tensor(mean, dtype=feats.dtype, device=feats.device)[None, :, None]
    s = torch.as_tensor(std, dtype=feats.dtype, device=feats.device)[None, :, None]
    return (feats - m) / (s + 1e-8)


def compute_corpus_cmvn(manifest, tokenizer, data_cfg: DataConfig, fe_cfg: FrontendConfig,
                        max_batches: int = 100, device="cuda") -> GlobalCMVN:
    """One pass in manifest order over the first min(max_batches,
    max(len // batch_size, 1)) batches, featurized on `device`."""
    from ..data.pipeline import BatchIterator
    from .features import featurize_batch

    it = BatchIterator(manifest, tokenizer, data_cfg, sample_rate=fe_cfg.sample_rate,
                       shuffle=False)
    acc = GlobalCMVN(fe_cfg.num_mels)
    with torch.inference_mode():
        for _ in range(min(max_batches, max(len(manifest) // data_cfg.batch_size, 1))):
            b = next(it)
            feats = featurize_batch(torch.from_numpy(b.audio).to(device), fe_cfg)
            acc.update(feats.cpu().numpy(), b.audio_lengths // fe_cfg.hop_length)
    return acc
