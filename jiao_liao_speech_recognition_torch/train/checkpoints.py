"""Checkpoints, the twin of the JAX package's ``train/checkpoints.py``.

``TrainCheckpointer`` keeps ``<dir>/<step:08d>/state.pt`` (``torch.save``
of the model and optimizer state dicts, the micro-step count, the seed
generator's state, any gradients accumulated mid-way through
``grad_accum_steps``, and host extras such as the data-iterator state) and
deletes all but the newest ``keep``; restoring into a fresh ``TrainState``
continues bit for bit. A file of the captured train step (a capturable
optimizer: step counts on the card, the learning rate a device scalar)
and one of the eager or CPU step load into either; the restore comes
before the step is captured (``train_loop``), so a graph reads the restored
tensors. Under a process group (the model wrapped by FSDP2,
parallel/mesh.py) ``save`` gathers the full model, optimizer and gradient
state (``get_state_dict`` with full state dicts offloaded to the CPU) and
the primary writes the same ``state.pt`` one process writes; ``restore``
reads it on the primary and broadcasts it into the shards
(``set_model_state_dict`` / ``set_optimizer_state_dict``). So a
checkpoint of N processes resumes in one and the reverse. On a model axis
(parallel/tp.py) the parts of each split tensor (parameter, Adam moment,
accumulated gradient) are also joined over the model group before the
primary writes, and every rank takes its part of the whole tensors the
primary broadcasts on restore, so a tensor-parallel run writes and reads
the one-process layout too. ``save_adapter_only`` / ``load_adapter_only`` read
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
            grads = {}
            if state.step % state.accum:  # a partial sum between updates
                grads = {n: p.grad for n, p in state.model.named_parameters()
                         if p.grad is not None}
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
        state.optimizer.load_state_dict(_as_this_route(state.optimizer, blob["optimizer"]))
        state.generator.set_state(blob["generator"])
        state.step = int(blob["step"])
        params = dict(state.model.named_parameters())
        for n, g in blob["grads"].items():
            params[n].grad = g.to(params[n].device)
        return blob["extra"]


def _as_this_route(optimizer, saved: Dict) -> Dict:
    """A saved optimizer state dict with this optimizer's own route: its
    groups' ``capturable`` flag (so the step counts load onto the card or
    stay on the host as this optimizer keeps them) and learning-rate form (a
    device scalar the train step writes, or a float). Either route's file
    loads into either."""
    groups = []
    for group, saved_group in zip(optimizer.param_groups, saved["param_groups"]):
        saved_group = dict(saved_group)
        for key in ("capturable", "lr"):
            if key in group:
                saved_group[key] = group[key]
        groups.append(saved_group)
    return {**saved, "param_groups": groups}


def _sharded(model) -> bool:
    from ..parallel.mesh import is_sharded

    return mh.is_initialized() and is_sharded(model)


def _param_names(state):
    """The optimizer's parameters' names, in its order (the integer ids of
    ``Optimizer.state_dict``)."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups for p in g["params"]]


def _split(model):
    """-> (the model group, name -> split dim) of a tensor-parallel model,
    else (None, {})."""
    tp = getattr(model, "tp", None)
    if tp is None or tp.size == 1:
        return None, {}
    return tp, model.tp_dims


def _gather(state):
    """-> (model, optimizer, gradient) state of a wrapped model, in one
    process's layout, full tensors on the primary's CPU (empty elsewhere)."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_state_dict

    from ..parallel.mesh import gather_part

    tp, dims = _split(state.model)
    # split tensors are joined over the model group first: every rank keeps
    # its full-over-fsdp part until then
    model_sd, optim_sd = get_state_dict(
        state.model, state.optimizer,
        options=StateDictOptions(full_state_dict=True, cpu_offload=tp is None))
    if tp is not None:
        model_sd = {n: (gather_part(v, dims[n], tp) if n in dims else v).cpu()
                    for n, v in model_sd.items()}
        optim_sd["state"] = {
            n: {k: (gather_part(v, dims[n], tp) if n in dims and torch.is_tensor(v) and v.dim()
                    else v).cpu() if torch.is_tensor(v) else v for k, v in st.items()}
            for n, st in optim_sd["state"].items()}
    grads = {}
    for n, p in state.model.named_parameters():
        if p.grad is not None:
            full = p.grad.full_tensor()
            if n in dims:
                full = gather_part(full, dims[n], tp)
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
    """Restore `path` into a wrapped model's state -> the extras: the
    primary reads it and broadcasts each whole tensor in turn, every rank
    keeps its part of one split over the model axis, and the model's and
    optimizer's state dicts of those parts are set as full (over fsdp)
    state dicts on every rank."""
    from torch.distributed.checkpoint.state_dict import (StateDictOptions, set_model_state_dict,
                                                         set_optimizer_state_dict)
    from torch.distributed.tensor import distribute_tensor

    from ..parallel.tp_rules import shard_tensor

    tp, dims = _split(state.model)
    blob = torch.load(path, map_location="cpu", weights_only=False) if mh.is_primary() else None
    names = _param_names(state)

    def layout(t):  # a tensor's (shape, dtype), anything else as it is
        return ("tensor", tuple(t.shape), t.dtype) if torch.is_tensor(t) else ("value", t)

    meta = mh.broadcast_object(None if blob is None else {
        "step": blob["step"], "generator": blob["generator"], "extra": blob["extra"],
        "model": {n: layout(t) for n, t in blob["model"].items()},
        "optim": {names[i]: {k: layout(v) for k, v in st.items()}
                  for i, st in blob["optimizer"]["state"].items()},
        "groups": [{**g, "params": [names[i] for i in g["params"]]}
                   for g in blob["optimizer"]["param_groups"]],
        "grads": {n: layout(g) for n, g in blob["grads"].items()}})
    dev = mh.device_type()

    def part(name, desc, whole):
        """This rank's part of a broadcast tensor (a value as it is)."""
        if desc[0] == "value":
            return desc[1]
        t = whole.to(dev) if whole is not None else torch.empty(desc[1], dtype=desc[2],
                                                                device=dev)
        torch.distributed.broadcast(t, src=0)
        dim = dims.get(name) if t.dim() else None
        return t if dim is None else shard_tensor(t, dim, tp.rank, tp.size)

    model_sd = {n: part(n, d, blob["model"][n] if blob else None)
                for n, d in meta["model"].items()}
    ids = {n: i for i, n in enumerate(names)}
    optim_sd = _as_this_route(state.optimizer, {
        "state": {n: {k: part(n, d, blob["optimizer"]["state"][ids[n]][k] if blob else None)
                      for k, d in st.items()}
                  for n, st in meta["optim"].items()},
        "param_groups": meta["groups"]})
    opts = StateDictOptions(full_state_dict=True)
    set_model_state_dict(state.model, model_sd, options=opts)
    set_optimizer_state_dict(state.model, state.optimizer, optim_sd, options=opts)
    params = dict(state.model.named_parameters())
    for n, d in meta["grads"].items():
        p = params[n]
        local = part(n, d, blob["grads"][n] if blob else None).to(p.device)
        p.grad = distribute_tensor(local, p.device_mesh, p.placements)
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
