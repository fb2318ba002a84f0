"""Global CMVN: corpus mean/std stats (.npz with ``mean`` and ``std``, as the
JAX package's ``cli prepare --cmvn`` writes them) applied as an affine op."""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np
import torch


def load_cmvn(path: str | Path) -> Tuple[np.ndarray, np.ndarray]:
    d = np.load(path)
    return d["mean"], d["std"]


def apply_global_cmvn(feats: torch.Tensor, mean, std) -> torch.Tensor:
    """[B, M, T] -> (feats - mean) / (std + 1e-8), per mel bin."""
    m = torch.as_tensor(mean, dtype=feats.dtype, device=feats.device)[None, :, None]
    s = torch.as_tensor(std, dtype=feats.dtype, device=feats.device)[None, :, None]
    return (feats - m) / (s + 1e-8)
