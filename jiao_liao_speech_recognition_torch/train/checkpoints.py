"""Checkpoints, the twin of the JAX package's ``train/checkpoints.py``.

``TrainCheckpointer`` keeps ``<dir>/<step:08d>/state.pt`` (``torch.save``
of the model and optimizer state dicts, the micro-step count, the seed
generator's state, any gradients accumulated mid-way through
``grad_accum_steps``, and host extras such as the data-iterator state) and
deletes all but the newest ``keep``; restoring into a fresh ``TrainState``
continues bit for bit. ``save_adapter_only`` / ``load_adapter_only`` read
and write the JAX package's adapter-only npz (key ``"/".join(flax path)``),
so an adapter trained by either package loads into the other.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..models import convert


class TrainCheckpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory).resolve()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _steps(self):
        return sorted(int(p.name) for p in self.dir.iterdir() if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, extra: Optional[Dict] = None) -> Path:
        d = self.dir / f"{step:08d}"
        d.mkdir(parents=True, exist_ok=True)
        blob = {
            "step": state.step,
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "generator": state.generator.get_state(),
            "grads": {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None},
            "extra": extra or {},
        }
        tmp = d / f"state.pt.tmp{os.getpid()}"
        torch.save(blob, tmp)
        os.replace(tmp, d / "state.pt")
        for s in self._steps()[: -self.keep]:
            shutil.rmtree(self.dir / f"{s:08d}", ignore_errors=True)
        return d

    def restore(self, state, step: Optional[int] = None) -> Optional[Dict]:
        """Load checkpoint `step` (default: the newest) into `state` in
        place -> its extras, or None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        blob = torch.load(self.dir / f"{step:08d}" / "state.pt", map_location="cpu",
                          weights_only=False)
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        state.generator.set_state(blob["generator"])
        state.step = int(blob["step"])
        params = dict(state.model.named_parameters())
        for n, g in blob["grads"].items():
            params[n].grad = g.to(params[n].device)
        return blob["extra"]


def save_adapter_only(path: str, model: torch.nn.Module) -> None:
    """The adapter-only npz of the JAX package (adapter leaves, flax paths)
    of a CTC, Whisper or joint model."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, **convert.adapter_arrays(model.state_dict(), convert.family_of(model)))


def load_adapter_only(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Copy the adapter leaves of an adapter-only npz into `model`."""
    params = dict(model.named_parameters())
    to_key = convert.FAMILIES[convert.family_of(model)][0]
    with np.load(path) as data, torch.no_grad():
        for key in data.files:
            name = to_key(tuple(key.split("/")))
            if name not in params:
                raise KeyError(f"{key}: no such adapter parameter in this model")
            params[name].copy_(torch.from_numpy(data[key]))
    return model
