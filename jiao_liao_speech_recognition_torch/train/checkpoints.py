"""Checkpoints, the twin of the JAX package's ``train/checkpoints.py``.

``TrainCheckpointer`` keeps ``<dir>/<step:08d>/state.pt`` (``torch.save``
of the model and optimizer state dicts, the micro-step count, the seed
generator's state, any gradients accumulated mid-way through
``grad_accum_steps``, and host extras such as the data-iterator state) and
deletes all but the newest ``keep``; restoring into a fresh ``TrainState``
continues bit for bit. Under a process group (the model wrapped by FSDP2,
parallel/mesh.py) ``save`` gathers the full model, optimizer and gradient
state (``get_state_dict`` with full state dicts offloaded to the CPU) and
the primary writes the same ``state.pt`` one process writes; ``restore``
reads it on the primary and broadcasts it into the shards
(``set_model_state_dict`` / ``set_optimizer_state_dict``). So a
checkpoint of N processes resumes in one and the reverse. ``save_adapter_only`` / ``load_adapter_only`` read
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
from ..parallel import multihost as mh


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
        """Write checkpoint `step` (a collective under a process group:
        the primary writes, after which it deletes all but the newest
        ``keep``)."""
        d = self.dir / f"{step:08d}"
        if _sharded(state.model):
            model_sd, optim_sd, grads = _gather(state)
        else:
            model_sd, optim_sd = state.model.state_dict(), state.optimizer.state_dict()
            grads = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}
        if mh.is_primary():
            d.mkdir(parents=True, exist_ok=True)
            blob = {"step": state.step, "model": model_sd, "optimizer": optim_sd,
                    "generator": state.generator.get_state(), "grads": grads,
                    "extra": extra or {}}
            tmp = d / f"state.pt.tmp{os.getpid()}"
            torch.save(blob, tmp)
            os.replace(tmp, d / "state.pt")
        mh.barrier("ckpt_save")
        if mh.is_primary():
            for s in self._steps()[: -self.keep]:
                shutil.rmtree(self.dir / f"{s:08d}", ignore_errors=True)
        mh.barrier("ckpt_gc")
        return d

    def restore(self, state, step: Optional[int] = None) -> Optional[Dict]:
        """Load checkpoint `step` (default: the newest) into `state` in
        place -> its extras, or None when there is no checkpoint."""
        step = mh.broadcast_object(step if step is not None else self.latest_step())
        if step is None:
            return None
        if _sharded(state.model):
            return _scatter(state, self.dir / f"{step:08d}" / "state.pt")
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


def _sharded(model) -> bool:
    from ..parallel.mesh import is_sharded

    return mh.is_initialized() and is_sharded(model)


def _param_names(state):
    """The optimizer's parameters' names, in its order (the integer ids of
    ``Optimizer.state_dict``)."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups for p in g["params"]]


def _gather(state):
    """-> (model, optimizer, gradient) state of a wrapped model, in one
    process's layout, full tensors on the primary's CPU (empty elsewhere)."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_state_dict

    model_sd, optim_sd = get_state_dict(
        state.model, state.optimizer,
        options=StateDictOptions(full_state_dict=True, cpu_offload=True))
    grads = {}
    for n, p in state.model.named_parameters():
        if p.grad is not None:
            full = p.grad.full_tensor()
            if mh.is_primary():
                grads[n] = full.cpu()
    if not mh.is_primary():
        return {}, {}, {}
    ids = {n: i for i, n in enumerate(_param_names(state))}
    optim_sd = {"state": {ids[n]: v for n, v in optim_sd["state"].items()},
                "param_groups": [{**g, "params": [ids[n] for n in g["params"]]}
                                 for g in optim_sd["param_groups"]]}
    return model_sd, optim_sd, grads


def _scatter(state, path: Path) -> Dict:
    """Restore `path` into a wrapped model's state: read on the primary,
    broadcast into every process's shards -> the extras."""
    from torch.distributed.checkpoint.state_dict import (StateDictOptions, set_model_state_dict,
                                                         set_optimizer_state_dict)
    from torch.distributed.tensor import distribute_tensor

    blob = torch.load(path, map_location="cpu", weights_only=False) if mh.is_primary() else None
    meta = mh.broadcast_object(None if blob is None else {
        "step": blob["step"], "generator": blob["generator"], "extra": blob["extra"],
        "grads": {n: (tuple(g.shape), g.dtype) for n, g in blob["grads"].items()}})
    model_sd = optim_sd = {}
    if blob is not None:
        names = _param_names(state)
        model_sd = blob["model"]
        optim_sd = {"state": {names[i]: v for i, v in blob["optimizer"]["state"].items()},
                    "param_groups": [{**g, "params": [names[i] for i in g["params"]]}
                                     for g in blob["optimizer"]["param_groups"]]}
    # one call each: set_state_dict takes a process without a model state
    # dict for an optimizer-only load
    opts = StateDictOptions(full_state_dict=True, broadcast_from_rank0=True)
    set_model_state_dict(state.model, model_sd, options=opts)
    set_optimizer_state_dict(state.model, state.optimizer, optim_sd, options=opts)
    params = dict(state.model.named_parameters())
    for n, (shape, dtype) in meta["grads"].items():
        p = params[n]
        full = (blob["grads"][n] if blob is not None else torch.empty(shape, dtype=dtype))
        full = full.to(p.device)
        torch.distributed.broadcast(full, src=0)
        p.grad = distribute_tensor(full, p.device_mesh, p.placements)
    state.generator.set_state(meta["generator"])
    state.step = int(meta["step"])
    return meta["extra"]


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
