"""Tensor parallelism at run time: a rank's place in its model group, the
Megatron collectives, and the in-place split of a model
(``apply_tp``) by the rules of ``parallel/tp_rules.py``.

The JAX package states tensor parallelism as parameter shardings and lets
XLA insert the all-reduces. Here each rank holds plain tensors, its own
part of every split parameter (``apply_tp`` replaces them in place), and
the layers call the collectives themselves (models/layers.py):

* a column-parallel layer (q/k/v, fc1) reads the replicated input through
  ``enter`` (identity forward; its backward all-reduces the gradient,
  Megatron's f) and gives this rank's columns: its heads, its hidden units;
* a row-parallel layer (out_proj, fc2) computes its f32 partial product
  over its rows, ``reduce`` sums the ranks' partials (all-reduce forward,
  identity backward, Megatron's g), and the bias and the residual are
  added once, after the sum;
* the vocab-split embedding looks its rows up masked and ``reduce``s, and
  its tied logits are this rank's vocab columns joined by ``gather``.

Every rank of a model group holds the same replicated activations, so the
gradients of replicated parameters come out whole and equal on each, save
the WF inserts that a split layer reads in part: they pass through
``enter`` too, which sums their gradients over the group.

An int8 serving model (``ModelBundle.quantize``) splits by the same rules
(``kernel_q`` as its kernel, a column layer's scale with its columns, the
int8 table by vocab rows), before or after the quantization, to the same
bits: a split row layer quantizes its rows with the whole column's scale
(``Dense.quantized``).

Outside autograd (serving), ``reduce`` all-reduces the partial in place
and ``enter`` is the tensor itself. A group may also be a stand-in object
with ``all_reduce(t)`` (-> the sum) and ``all_gather(t)`` (-> the ranks'
tensors): one process playing every rank of a group in turn, as
chip_smoke.py's phase 20 does on one card.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from .tp_rules import model_dim, shard_tensor, tp_placement


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if not isinstance(group, dist.ProcessGroup):
        return group.all_reduce(t)
    dist.all_reduce(t, group=group)
    return t


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, gy):
        return gy, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        return _all_reduce(gy.contiguous().clone(), ctx.group), None


def _gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    if not isinstance(group, dist.ProcessGroup):
        return torch.cat(group.all_gather(x), dim=dim)
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank, dim):
        ctx.rank, ctx.n, ctx.dim = rank, x.shape[dim], dim
        return _gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, gy):
        return gy.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None, None, None


def _tracked(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class TPGroup:
    """This rank's place in its model group: `rank` of `size`, and the
    process group of the group's ranks (or a stand-in, see the module
    docstring; None where the caller sums the ranks' partials itself: the
    collectives then raise)."""

    def __init__(self, rank: int, size: int, group=None):
        self.rank, self.size, self.group = int(rank), int(size), group

    def _need_group(self, what: str) -> None:
        if self.group is None:
            raise RuntimeError(f"TPGroup.{what}: no process group (a simulated rank sums its "
                               "partials itself)")

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of the group's `t` (Megatron's g: all-reduce forward,
        identity backward). Outside autograd `t` itself is summed in place."""
        self._need_group("reduce")
        if _tracked(t):
            return _Reduce.apply(t, self.group)
        return _all_reduce(t, self.group)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """`t` entering a split layer (Megatron's f: identity forward,
        all-reduced gradient)."""
        if not _tracked(t):
            return t
        self._need_group("enter")
        return _Enter.apply(t, self.group)

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The group's parts of `t` joined along `dim` in rank order (the
        backward takes this rank's part of the gradient)."""
        self._need_group("gather")
        dim = dim % t.dim()
        if _tracked(t):
            return _Gather.apply(t, self.group, self.size, self.rank, dim)
        return _gather(t, self.group, self.size, dim)

    def agree(self, flag: bool) -> bool:
        """True when `flag` is true on every rank of the group (a host read
        that must take the same branch on each)."""
        if self.group is None:
            return flag
        nccl = (isinstance(self.group, dist.ProcessGroup)
                and dist.get_backend(self.group) == "nccl")
        t = torch.tensor([0 if flag else 1], dtype=torch.int32, device="cuda" if nccl else "cpu")
        return int(_all_reduce(t, self.group).item()) == 0


def model_tp(model: torch.nn.Module) -> Optional[TPGroup]:
    """The TPGroup a model was split with (``apply_tp``), or None."""
    return getattr(model, "tp", None)


def check_capturable(model: torch.nn.Module, device: torch.device, who: str) -> None:
    """Raise ValueError where `who` cannot capture a step of `model` on
    `device` in a CUDA graph: a stand-in group (ranks played in one
    process) on a card, or an NCCL group started without
    ``TORCH_NCCL_ASYNC_ERROR_HANDLING=0`` (``multihost.initialize(
    graph_collectives=True)`` sets it). The caller asks for the eager step
    with ``graph=False``; nothing drops to it on its own."""
    tp = model_tp(model)
    if tp is None or torch.device(device).type != "cuda":
        return
    if not isinstance(tp.group, (dist.ProcessGroup, type(None))):
        raise ValueError(f"{who}: a stand-in model group (ranks played in one process) cannot "
                         "be captured in a CUDA graph; graph=False runs the step eagerly")
    if os.environ.get("TORCH_NCCL_ASYNC_ERROR_HANDLING") != "0":
        raise ValueError(f"{who}: capturing a split model's NCCL collectives needs "
                         "TORCH_NCCL_ASYNC_ERROR_HANDLING=0 before the group starts: "
                         "multihost.initialize(graph_collectives=True)")


def split_dims(model: torch.nn.Module, tp: int) -> Dict[str, int]:
    """name -> the dim the model axis splits, for each parameter (or int8
    buffer) of the whole `model` that the rules split at model-axis size
    `tp`."""
    out = {}
    for name, p in itertools.chain(model.named_parameters(), model.named_buffers()):
        d = model_dim(tp_placement(name, tuple(p.shape), tp))
        if d is not None:
            out[name] = d
    return out


def role_dims(model: torch.nn.Module) -> Dict[str, int]:
    """name -> split dim of each split tensor of a split `model`, read off
    its layers' roles (``model.tp_dims`` of a model quantized after its
    split, whose int8 leaves the split never saw)."""
    from ..models.layers import Dense, Int8Dense
    from ..models.whisper import Int8TiedEmbedding, TiedEmbedding

    out = {}
    for name, m in model.named_modules():
        if isinstance(m, (Dense, Int8Dense)) and m.tp is not None:
            col = m.tp_mode == "column"
            leaves = {"kernel": 1 if col else 0, "kernel_q": 1 if col else 0}
            if col:
                leaves.update(bias=0, scale=0)
        elif isinstance(m, (TiedEmbedding, Int8TiedEmbedding)) and m.tp is not None:
            leaves = {"embedding": 0, "embedding_q": 0, "scale": 0}
        else:
            continue
        for leaf, d in leaves.items():
            if getattr(m, leaf, None) is not None:
                out[f"{name}.{leaf}"] = d
    return out


def apply_tp(model: torch.nn.Module, tp: TPGroup) -> torch.nn.Module:
    """Split a whole `model` in place into rank ``tp.rank``'s part: every
    parameter the rules split is replaced by its rank's slice, and the
    layers learn their role (column or row, their heads, the vocab rows
    of a tied embedding, the hidden columns of a dropout), an int8 model's
    buffers and layers alike. A model split already, or `tp.size` 1, is
    returned as it is. Raises ValueError where a split layer's heads do
    not divide by the group size."""
    from ..models.adapters import AttAdapter
    from ..models.layers import MLP, Dense, Int8Dense, MultiHeadAttention
    from ..models.whisper import Int8TiedEmbedding, TiedEmbedding

    if model_tp(model) is not None or tp.size == 1:
        return model
    dims = split_dims(model, tp.size)
    owner = {}  # id(Dense or Int8Dense) -> its kernel's split dim
    for name, m in model.named_modules():
        for leaf in ("kernel", "kernel_q"):
            if isinstance(m, (Dense, Int8Dense)) and f"{name}.{leaf}" in dims:
                owner[id(m)] = dims[f"{name}.{leaf}"]
    for name, m in model.named_modules():
        if isinstance(m, MultiHeadAttention) and id(m.q_proj) in owner:
            if m.num_heads % tp.size:
                raise ValueError(f"{name}: {m.num_heads} heads do not divide over a model "
                                 f"axis of {tp.size}")
            m.num_heads //= tp.size
        elif isinstance(m, MLP) and id(m.fc1) in owner and m.dropout is not None:
            m.dropout.tp = tp
        elif isinstance(m, AttAdapter) and id(m.out_proj) in owner:
            m.out_proj.tp_input = "replicated"
        elif isinstance(m, TiedEmbedding) and f"{name}.embedding" in dims:
            m.tp = tp
        elif isinstance(m, Int8TiedEmbedding) and f"{name}.embedding_q" in dims:
            m.tp = tp
        if isinstance(m, (Dense, Int8Dense)) and id(m) in owner:
            m.tp = tp
            m.tp_mode = "column" if owner[id(m)] == 1 else "row"
    with torch.no_grad():
        for name, d in dims.items():
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            old = getattr(mod, leaf)
            part = shard_tensor(old.detach(), d, tp.rank, tp.size)
            if isinstance(old, torch.nn.Parameter):
                part = torch.nn.Parameter(part, requires_grad=old.requires_grad)
            setattr(mod, leaf, part)  # a buffer stays a buffer
    model.tp = tp
    model.tp_dims = dims
    return model
