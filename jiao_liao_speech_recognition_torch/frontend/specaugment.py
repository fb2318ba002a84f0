"""SpecAugment (the twin of the JAX package's ``frontend/specaugment.py``):
frequency and time masks on [B, num_mels, T] log-mel features, drawn from
an explicit ``torch.Generator``. Counts, widths and the fill rule are the
JAX module's; the random bits are not (tests compare distributions).

``rows`` = (first row, global rows) draws every row's masks for the global
batch and keeps these rows', so a row gets the same masks whichever
process of a data-parallel run holds it."""

from __future__ import annotations

import torch

from ..utils.config import SpecAugmentConfig


def _mask_axis(gen: torch.Generator, x: torch.Tensor, axis: int, num_masks: int,
               max_width: int, fill, rows=None) -> torch.Tensor:
    """`num_masks` random contiguous masks along `axis` (1 or 2) per example:
    width uniform in [0, max_width], start uniform in [0, max(size - width, 1))."""
    size, b = x.shape[axis], x.shape[0]
    first, total = rows or (0, b)
    widths = torch.randint(0, max(max_width, 1) + 1, (total, num_masks),
                           generator=gen)[first:first + b]
    hi = torch.clamp(size - widths, min=1)
    u = torch.rand(total, num_masks, generator=gen)[first:first + b]
    starts = torch.minimum((u * hi).long(), hi - 1)
    pos = torch.arange(size)
    hit = (pos[None, None, :] >= starts[..., None]) & (pos[None, None, :] < (starts + widths)[..., None])
    mask = hit.any(dim=1).to(x.device)  # [B, size]
    shape = [b, 1, 1]
    shape[axis] = size
    return torch.where(mask.reshape(shape), fill, x)


def spec_augment(gen: torch.Generator, features: torch.Tensor,
                 cfg: SpecAugmentConfig, rows=None) -> torch.Tensor:
    """Masked copy of [B, num_mels, T] features. `gen` is a CPU generator;
    the masks are drawn on the host and moved to the features' device."""
    if not cfg.enabled:
        return features
    if cfg.replace_with_zero:
        fill = torch.zeros((), dtype=features.dtype, device=features.device)
    else:
        fill = features.mean(dim=(1, 2), keepdim=True)
    t = features.shape[2]
    features = _mask_axis(gen, features, 1, cfg.num_freq_masks, cfg.freq_mask_width, fill,
                          rows)
    return _mask_axis(gen, features, 2, cfg.num_time_masks,
                      int(cfg.time_mask_fraction * t), fill, rows)
