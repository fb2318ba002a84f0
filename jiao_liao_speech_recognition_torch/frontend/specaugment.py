"""SpecAugment (the twin of the JAX package's ``frontend/specaugment.py``):
frequency and time masks on [B, num_mels, T] log-mel features, drawn from
an explicit ``torch.Generator``. Counts, widths and the fill rule are the
JAX module's; the random bits are not (tests compare distributions).

The draw and the mask are apart: ``draw_masks`` draws each mask's width
and start fraction on the host from a CPU generator, ``apply_masks`` builds
the masks on the features' device from those draws (a captured train step
reads them from a static buffer the host fills before each replay);
``spec_augment`` is the two in one call.

``rows`` = (first row, global rows) draws every row's masks for the global
batch and keeps these rows', so a row gets the same masks whichever
process of a data-parallel run holds it."""

from __future__ import annotations

from typing import Dict

import torch

from ..utils.config import SpecAugmentConfig

AXES = (("freq", 1), ("time", 2))


def draw_masks(gen: torch.Generator, batch: int, num_mels: int, frames: int,
               cfg: SpecAugmentConfig, rows=None) -> Dict[str, torch.Tensor]:
    """The host's draws for `batch` rows of [num_mels, frames] features ->
    {"freq_width", "freq_u", "time_width", "time_u"}, CPU tensors [batch,
    masks] (widths int64 uniform in [0, max_width], u f32 uniform in [0, 1)),
    in the order the masks are applied."""
    first, total = rows or (0, batch)
    masks = {"freq": (cfg.num_freq_masks, cfg.freq_mask_width),
             "time": (cfg.num_time_masks, int(cfg.time_mask_fraction * frames))}
    out = {}
    for name, _ in AXES:
        n, max_width = masks[name]
        out[f"{name}_width"] = torch.randint(0, max(max_width, 1) + 1, (total, n),
                                             generator=gen)[first:first + batch]
        out[f"{name}_u"] = torch.rand(total, n, generator=gen)[first:first + batch]
    return out


def apply_masks(features: torch.Tensor, draws: Dict[str, torch.Tensor],
                cfg: SpecAugmentConfig) -> torch.Tensor:
    """Masked copy of [B, num_mels, T] features from ``draw_masks``'s draws
    (on the features' device): each mask starts at min(floor(u x hi), hi -
    1), hi = max(size - width, 1), and covers `width` positions."""
    if cfg.replace_with_zero:
        fill = torch.zeros((), dtype=features.dtype, device=features.device)
    else:
        fill = features.mean(dim=(1, 2), keepdim=True)
    b = features.shape[0]
    for name, axis in AXES:
        size = features.shape[axis]
        widths, u = draws[f"{name}_width"], draws[f"{name}_u"]
        hi = torch.clamp(size - widths, min=1)
        starts = torch.minimum((u * hi).long(), hi - 1)
        pos = torch.arange(size, device=features.device)
        hit = ((pos[None, None, :] >= starts[..., None])
               & (pos[None, None, :] < (starts + widths)[..., None]))
        shape = [b, 1, 1]
        shape[axis] = size
        features = torch.where(hit.any(dim=1).reshape(shape), fill, features)
    return features


def spec_augment(gen: torch.Generator, features: torch.Tensor,
                 cfg: SpecAugmentConfig, rows=None) -> torch.Tensor:
    """Masked copy of [B, num_mels, T] features. `gen` is a CPU generator;
    the draws are made on the host and moved to the features' device."""
    if not cfg.enabled:
        return features
    b, num_mels, frames = features.shape
    draws = draw_masks(gen, b, num_mels, frames, cfg, rows)
    return apply_masks(features, {k: v.to(features.device) for k, v in draws.items()}, cfg)
