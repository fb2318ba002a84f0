"""The training mesh on ``torch.distributed`` (the JAX package's
``parallel/mesh.py``), one process per card.

Axes, as in JAX: ``data`` replicates the model over batch shards,
``fsdp`` shards parameters and optimizer state (ZeRO), ``model`` is tensor
parallelism, which is not ported: ``model_axis > 1`` raises.

* ``mesh_shape`` is JAX's ``build_mesh`` / ``build_mesh_for_batch``
  arithmetic (shape and ``ValueError`` for the same inputs);
  ``build_mesh`` / ``build_mesh_for_batch`` make the
  ``init_device_mesh`` over the process group's world. Where JAX would
  take a sub-mesh smaller than the world (a batch that no larger data axis
  divides, or an explicit ``data_axis`` that leaves devices over), the
  port raises instead: a process group cannot leave ranks idle.
* ``shard_model`` (JAX's ``shard_state``): FSDP2 ``fully_shard`` on every
  transformer block of every stack, then on the root, over
  ``mesh["data", "fsdp"]``: HSDP (replicated over ``data``, sharded over
  ``fsdp``), plain data parallelism at ``fsdp`` 1. Each parameter of two
  or more dims is sharded along its largest axis when ``fsdp`` divides
  it (JAX's ``_fsdp_rule``), else along dim 0, where FSDP2 pads and JAX
  replicates: that changes memory, not arithmetic. The optimizer built
  after wrapping keeps Adam's moments on the same shards (JAX's ZeRO
  opt-state rule). No mixed-precision policy: parameters stay f32 and the
  modules keep their own casts, so each rank computes as one process does.
  The wrapped model is called only through ``forward`` (every loss does):
  FSDP2 gathers a block's parameters in its forward's pre-hook, so the
  kernels see plain tensors. Anything else (evaluation, the saved bundle)
  reads ``full_model``.
* ``shard_batch``: this rank's rows of a global batch, or the whole
  batch when it is ragged (JAX's replication fallback).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.config import MeshConfig
from . import multihost as mh

TP_ITEM = "ROADMAP queue 1 item 9 (the tensor-parallel remainder)"


def mesh_shape(cfg: Optional[MeshConfig], n_devices: int,
               batch_size: Optional[int] = None) -> Tuple[int, int, int]:
    """(data, fsdp, model) of JAX's ``build_mesh(cfg, devices)`` over
    `n_devices`, or of ``build_mesh_for_batch(cfg, batch_size, devices)``
    when `batch_size` is given; the same ``ValueError``s."""
    cfg = cfg or MeshConfig()
    fsdp, model = max(cfg.fsdp_axis, 1), max(cfg.model_axis, 1)
    if batch_size is not None:
        if cfg.data_axis > 0:
            need = cfg.data_axis * fsdp * model
            if need > n_devices:
                raise ValueError(f"mesh needs {need} devices but only {n_devices} available")
            return mesh_shape(cfg, need)
        data = 1
        for d in range(n_devices // (fsdp * model), 0, -1):
            if batch_size % (d * fsdp) == 0:
                data = d
                break
        sub = min(data * fsdp * model, n_devices)
        return mesh_shape(dataclasses.replace(cfg, data_axis=data), sub)
    if n_devices % (fsdp * model) != 0:
        raise ValueError(f"{n_devices} devices not divisible by fsdp*model={fsdp * model}")
    data = cfg.data_axis if cfg.data_axis > 0 else n_devices // (fsdp * model)
    if data * fsdp * model != n_devices:
        raise ValueError(f"mesh {data}x{fsdp}x{model} != {n_devices} devices; fix MeshConfig")
    return data, fsdp, model


def _refuse_tp(cfg: MeshConfig) -> None:
    if cfg.model_axis > 1:
        raise NotImplementedError(
            f"model_axis={cfg.model_axis}: tensor parallelism is not ported yet: {TP_ITEM}")


def _device_mesh(cfg: MeshConfig, shape, device_type: Optional[str]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or mh.device_type(), tuple(shape),
                            mesh_dim_names=tuple(cfg.axis_names))


def build_mesh(cfg: Optional[MeshConfig] = None, world: Optional[int] = None,
               device_type: Optional[str] = None):
    """The ('data', 'fsdp', 'model') DeviceMesh over the process group's
    `world` ranks (default: all of them)."""
    cfg = cfg or MeshConfig()
    _refuse_tp(cfg)
    return _device_mesh(cfg, mesh_shape(cfg, world or mh.process_count()), device_type)


def build_mesh_for_batch(cfg: Optional[MeshConfig], batch_size: int,
                         world: Optional[int] = None, device_type: Optional[str] = None):
    """JAX's ``build_mesh_for_batch`` over the process group: with
    ``data_axis`` -1 the largest data axis whose product with fsdp divides
    the batch. A mesh smaller than the world raises ``ValueError``."""
    cfg = cfg or MeshConfig()
    _refuse_tp(cfg)
    world = world or mh.process_count()
    shape = mesh_shape(cfg, world, batch_size)
    if math.prod(shape) != world:
        raise ValueError(
            f"batch_size={batch_size} on a world of {world} processes gives a "
            f"{'x'.join(map(str, shape))} mesh: a process group cannot leave ranks idle; "
            "pick a batch size whose data*fsdp split covers every rank, or set mesh.data_axis")
    return _device_mesh(cfg, shape, device_type)


def dp_mesh(mesh):
    """The mesh's (data, fsdp) sub-mesh, the one FSDP2 wraps over."""
    return mesh[tuple(mesh.mesh_dim_names[:2])]


def placement_rule(fsdp_n: int) -> Callable:
    """JAX's ``_fsdp_rule`` as a ``shard_placement_fn``: the largest axis
    of a parameter of two or more dims when `fsdp_n` (> 1) divides it, else
    dim 0 (a whole parameter at `fsdp_n` 1, where JAX replicates)."""
    from torch.distributed.tensor import Shard

    def rule(p: torch.Tensor):
        if p.ndim >= 2 and fsdp_n > 1:
            axis = int(np.argmax(p.shape))
            if p.shape[axis] % fsdp_n == 0:
                return Shard(axis)
        return Shard(0)

    return rule


def is_sharded(model: torch.nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def shard_model(mesh, model: torch.nn.Module) -> torch.nn.Module:
    """Wrap `model` in place with FSDP2 (see the module docstring) and
    return it; a model already wrapped is returned as it is."""
    from torch.distributed.fsdp import fully_shard

    from ..models.layers import TransformerBlock

    if is_sharded(model):
        return model
    sub = dp_mesh(mesh)
    rule = placement_rule(mesh[mesh.mesh_dim_names[1]].size())
    for block in [m for m in model.modules() if isinstance(m, TransformerBlock)]:
        fully_shard(block, mesh=sub, shard_placement_fn=rule)
    fully_shard(model, mesh=sub, shard_placement_fn=rule)
    return model


def full_model(model: torch.nn.Module, make: Callable[[], torch.nn.Module]) -> torch.nn.Module:
    """A plain model from `make()` holding the wrapped `model`'s full
    weights, on every rank (a collective); `model` itself when it is not
    wrapped."""
    if not is_sharded(model):
        return model
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

    sd = get_model_state_dict(model, options=StateDictOptions(full_state_dict=True))
    plain = make()
    plain.load_state_dict(sd)
    del sd
    return plain


def dp_rank(mesh) -> int:
    """This rank's index over the (data, fsdp) axes, row-major."""
    d, f = mesh.get_coordinate()[:2]
    return d * mesh.size(1) + f


def shard_batch(mesh, batch: Dict, global_rows: Optional[int] = None) -> Dict:
    """This rank's part of a device batch (a dict of tensors): rows
    [r B / n, (r + 1) B / n) of each tensor whose leading dim is the global
    batch B, n = data * fsdp; a ragged batch (B % n != 0) is kept whole on
    every rank, JAX's replication fallback (identical gradients average to
    the same update). `global_rows` is the cross-process batch size (JAX's
    ``Batch.global_rows``): tensors whose leading dim times the process
    count equals it are this process's slice already and stay as they
    are. The result carries ``"rows"`` = (first global row, global rows),
    which the losses read to draw each row's random values for the global
    batch."""
    n = mesh.size(0) * mesh.size(1)
    r = dp_rank(mesh)
    nproc = mh.process_count()
    lead = next(v.shape[0] for v in batch.values() if isinstance(v, torch.Tensor) and v.ndim)
    gr = global_rows if global_rows is not None else lead
    if lead * nproc == gr and gr % n == 0 and nproc > 1:
        out = dict(batch)  # the loader collated this process's rows
        out["rows"] = (r * lead, gr)
        return out
    if lead != gr or gr % n:
        out = dict(batch)  # ragged: the whole batch on every rank
        out["rows"] = (0, lead)
        return out
    k = gr // n
    out = {key: v[r * k:(r + 1) * k] if isinstance(v, torch.Tensor) and v.ndim else v
           for key, v in batch.items()}
    out["rows"] = (r * k, gr)
    return out
