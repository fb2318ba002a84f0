"""The training mesh on ``torch.distributed`` (the JAX package's
``parallel/mesh.py``), one process per card.

Axes, as in JAX: ``data`` replicates the model over batch shards,
``fsdp`` shards parameters and optimizer state (ZeRO), ``model`` is
Megatron tensor parallelism (parallel/tp.py, the rules of
parallel/tp_rules.py). Ranks are laid out row-major over (data, fsdp,
model): the ranks of one model group are neighbours, hold the same batch
rows and split the weights between them.

* ``mesh_shape`` is JAX's ``build_mesh`` / ``build_mesh_for_batch``
  arithmetic (shape and ``ValueError`` for the same inputs);
  ``build_mesh`` / ``build_mesh_for_batch`` make the
  ``init_device_mesh`` over the process group's world. Where JAX would
  take a sub-mesh smaller than the world (a batch that no larger data axis
  divides, or an explicit ``data_axis`` that leaves devices over), the
  port raises instead: a process group cannot leave ranks idle.
* ``shard_model`` (JAX's ``shard_state``): on a model axis larger than 1
  first ``parallel/tp.apply_tp`` over ``mesh["model"]`` (each rank keeps
  its part of every split parameter, as plain tensors); then FSDP2
  ``fully_shard`` on every transformer block of every stack, then on the
  root, over ``mesh["data", "fsdp"]``: HSDP (replicated over ``data``,
  sharded over ``fsdp``), plain data parallelism at ``fsdp`` 1. Each
  parameter is sharded along the dim JAX's rules give it over fsdp
  (``_fsdp_rule``'s largest axis; on a model axis, ``fsdp_tp_sharding``'s
  largest free dim of a split kernel), else along dim 0, where FSDP2 pads
  and JAX replicates: that changes memory, not arithmetic. The optimizer
  built after wrapping keeps Adam's moments on the same shards (JAX's ZeRO
  opt-state rule). No mixed-precision policy: parameters stay f32 and the
  modules keep their own casts, so each rank computes as one process does.
  The wrapped model is called only through ``forward`` (every loss does):
  FSDP2 gathers a block's parameters in its forward's pre-hook, so the
  kernels see plain tensors. Anything else (evaluation, the saved bundle)
  reads ``full_model``, which also joins the model axis's parts.
* ``shard_batch``: this rank's rows of a global batch (the same rows on
  every rank of a model group), or the whole batch when it is ragged
  (JAX's replication fallback).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ..utils.config import MeshConfig
from . import multihost as mh
from .tp import TPGroup, apply_tp, model_tp
from .tp_rules import fsdp_tp_placement


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


def _device_mesh(cfg: MeshConfig, shape, device_type: Optional[str]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or mh.device_type(), tuple(shape),
                            mesh_dim_names=tuple(cfg.axis_names))


def build_mesh(cfg: Optional[MeshConfig] = None, world: Optional[int] = None,
               device_type: Optional[str] = None):
    """The ('data', 'fsdp', 'model') DeviceMesh over the process group's
    `world` ranks (default: all of them)."""
    cfg = cfg or MeshConfig()
    return _device_mesh(cfg, mesh_shape(cfg, world or mh.process_count()), device_type)


def build_mesh_for_batch(cfg: Optional[MeshConfig], batch_size: int,
                         world: Optional[int] = None, device_type: Optional[str] = None):
    """JAX's ``build_mesh_for_batch`` over the process group: with
    ``data_axis`` -1 the largest data axis whose product with fsdp divides
    the batch. A mesh smaller than the world raises ``ValueError``."""
    cfg = cfg or MeshConfig()
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


def tp_group(mesh) -> TPGroup:
    """This rank's place on the mesh's model axis (size 1 without one)."""
    size = mesh.size(2)
    if size == 1:
        return TPGroup(0, 1)
    return TPGroup(mesh.get_coordinate()[2], size, mesh.get_group(2))


def dp_group(mesh):
    """The groups of the mesh's data and fsdp axes wider than one rank: a
    sum over each in turn is a sum over this rank's (data, fsdp) ranks, the
    ranks that share its model coordinate; None (the whole world) at model
    1."""
    if mesh.size(2) == 1:
        return None
    return tuple(mesh.get_group(d) for d in (0, 1) if mesh.size(d) > 1)


def _fsdp_dim(spec) -> int:
    return spec.index("fsdp") if "fsdp" in spec else 0


def is_sharded(model: torch.nn.Module) -> bool:
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)


def model_placement_rule(model: torch.nn.Module, tp: int, fsdp_n: int) -> Callable:
    """JAX's ``param_sharding`` as a ``shard_placement_fn`` for a whole
    `model` about to be split over a model axis of `tp` (``_fsdp_rule`` at
    tp 1, ``fsdp_tp_sharding`` above; the rule reads each parameter's whole
    shape and name): the dim it gives fsdp, else dim 0. Make it before
    ``apply_tp``; it maps the split parameters by name when they are asked
    for."""
    from torch.distributed.tensor import Shard

    want = {name: _fsdp_dim(fsdp_tp_placement(name, tuple(p.shape), tp, fsdp_n))
            for name, p in model.named_parameters()}
    by_id = {}

    def rule(p: torch.nn.Parameter):
        if not by_id:
            by_id.update({id(q): want[n] for n, q in model.named_parameters()})
        return Shard(by_id[id(p)])

    return rule


def shard_model(mesh, model: torch.nn.Module) -> torch.nn.Module:
    """Split `model` in place over the mesh's model axis (``apply_tp``) and
    wrap it with FSDP2 (see the module docstring); return it. A model
    already wrapped is returned as it is."""
    from torch.distributed.fsdp import fully_shard

    from ..models.layers import TransformerBlock

    if is_sharded(model):
        return model
    sub = dp_mesh(mesh)
    tp = tp_group(mesh)
    rule = model_placement_rule(model, tp.size, mesh[mesh.mesh_dim_names[1]].size())
    apply_tp(model, tp)
    for block in [m for m in model.modules() if isinstance(m, TransformerBlock)]:
        fully_shard(block, mesh=sub, shard_placement_fn=rule)
    fully_shard(model, mesh=sub, shard_placement_fn=rule)
    return model


def gather_split(sd: Dict[str, torch.Tensor], model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """`sd` (tensors keyed by `model`'s parameter names, this rank's parts
    of the split ones) with each split tensor joined over the model axis
    (a collective over the model group; `sd` itself for an unsplit
    model)."""
    tp = model_tp(model)
    if tp is None or tp.size == 1:
        return sd
    out = dict(sd)
    for name, dim in model.tp_dims.items():
        if name in sd:
            out[name] = gather_part(sd[name], dim, tp)
    return out


def gather_part(t: torch.Tensor, dim: int, tp: TPGroup) -> torch.Tensor:
    """The model group's parts of `t` joined along `dim` (a collective)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(tp.size)]
    torch.distributed.all_gather(parts, t, group=tp.group)
    return torch.cat(parts, dim=dim)


def full_model(model: torch.nn.Module, make: Callable[[], torch.nn.Module]) -> torch.nn.Module:
    """A plain model from `make()` holding the wrapped `model`'s full
    weights, joined over the fsdp and model axes, on every rank (a
    collective); `model` itself when it is neither wrapped nor split."""
    if not is_sharded(model) and model_tp(model) is None:
        return model
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

    sd = (get_model_state_dict(model, options=StateDictOptions(full_state_dict=True))
          if is_sharded(model) else model.state_dict())
    sd = gather_split(sd, model)
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
    batch B, n = data * fsdp and r this rank's (data, fsdp) index, so the
    ranks of a model group take the same rows; a ragged batch (B % n != 0)
    is kept whole on every rank, JAX's replication fallback (identical
    gradients average to the same update). `global_rows` is the global
    batch size (JAX's ``Batch.global_rows``): tensors whose leading dim
    times n equals it are this rank's slice already (the loader collated
    its (data, fsdp) rank's rows) and stay as they are. The result carries
    ``"rows"`` = (first global row, global rows), which the losses read to
    draw each row's random values for the global batch, and ``"dp"`` = (n,
    ``dp_group``: the groups of the (data, fsdp) ranks or None for the whole
    world, r), over which the losses sum."""
    n = mesh.size(0) * mesh.size(1)
    r = dp_rank(mesh)
    dp = (n, dp_group(mesh), r)
    lead = next(v.shape[0] for v in batch.values() if isinstance(v, torch.Tensor) and v.ndim)
    gr = global_rows if global_rows is not None else lead
    if lead * n == gr and n > 1:
        out = dict(batch)  # the loader collated this rank's rows
        out["rows"], out["dp"] = (r * lead, gr), dp
        return out
    if lead != gr or gr % n:
        out = dict(batch)  # ragged: the whole batch on every rank
        out["rows"], out["dp"] = (0, lead), dp
        return out
    k = gr // n
    out = {key: v[r * k:(r + 1) * k] if isinstance(v, torch.Tensor) and v.ndim else v
           for key, v in batch.items()}
    out["rows"], out["dp"] = (r * k, gr), dp
    return out
