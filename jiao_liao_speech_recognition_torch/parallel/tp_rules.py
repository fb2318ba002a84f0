"""Megatron tensor-parallel placement rules, the JAX package's
``parallel/tp_rules.py`` over the port's parameter names (the flax path
joined by "."; models/convert.py is a rename, so the names are JAX's).

A parameter's placement is a tuple with one entry a dim: ``"model"`` where
the dim is split over the mesh's model axis, ``"fsdp"`` where it is split
over the fsdp axis, None where it is whole. The rules match JAX's on name
suffix and shape alone:

* ``q_proj`` / ``k_proj`` / ``v_proj`` / ``fc1`` kernels [in, out]: the
  columns (``(None, "model")``), and their biases (``("model",)``);
* ``out_proj`` / ``fc2`` kernels: the rows (``("model", None)``);
* ``embed_tokens.embedding`` [V, d] (any ``embedding``): the vocab rows;
* the int8 serving leaves (``ModelBundle.quantize``), as JAX's
  ``bundle.shard(mesh).quantize()`` places them: ``kernel_q`` as its
  ``kernel``; a column layer's per-column ``scale`` with its columns, a row
  layer's ``scale`` whole; ``embedding_q`` [V, d] and the tied table's
  per-row ``scale`` [V] by vocab rows;
* replication where tp does not divide that dim, and for everything else
  (LayerNorms, convolutions, the CTC head, the row layers' biases, every
  WF insert ``a`` / ``g`` / ``b``, the Att adapter's ``qkv_proj``; its
  ``out_proj`` is row-split like any other);

then ``fsdp_tp_placement`` (JAX's ``fsdp_tp_sharding``): a replicated
parameter takes JAX's FSDP rule (its largest axis over fsdp when fsdp
divides it, a parameter of two or more dims), and a split kernel also
splits the largest of its other dims over fsdp when fsdp divides it.

``shard_tensor`` cuts a whole tensor into a rank's part along the dim
the rules give (parallel/mesh.py's ``gather_part`` joins the parts).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

COLUMN_KERNELS = ("q_proj", "k_proj", "v_proj", "fc1")
ROW_KERNELS = ("out_proj", "fc2")

Placement = Tuple[Optional[str], ...]


def _module(name: str) -> str:
    """The last component of `name` that names a column or row layer ("" if
    none), as JAX's rule finds the owning module on the path."""
    mod = ""
    for k in name.split("."):
        if k in COLUMN_KERNELS + ROW_KERNELS:
            mod = k
    return mod


def tp_placement(name: str, shape: Sequence[int], tp: int) -> Placement:
    """JAX's ``tp_param_sharding`` rule for one parameter of the whole
    model (its full `shape`) at model-axis size `tp`."""
    nd = len(shape)
    repl = (None,) * nd
    if tp == 1 or nd == 0:
        return repl
    parts = name.split(".")
    leaf, mod = parts[-1], _module(name)
    if leaf in ("kernel", "kernel_q") and nd == 2:
        if mod in COLUMN_KERNELS and shape[1] % tp == 0:
            return (None, "model")
        if mod in ROW_KERNELS and shape[0] % tp == 0:
            return ("model", None)
    if leaf in ("bias", "scale") and mod in COLUMN_KERNELS and nd == 1 and shape[0] % tp == 0:
        return ("model",)
    if leaf in ("embedding", "embedding_q") and nd == 2 and shape[0] % tp == 0:
        return ("model", None)
    if (leaf == "scale" and nd == 1 and len(parts) > 1 and parts[-2] == "embed_tokens"
            and shape[0] % tp == 0):
        return ("model",)
    return repl


def fsdp_placement(shape: Sequence[int], fsdp: int) -> Placement:
    """JAX's ``_fsdp_rule``: the largest axis (the first of equals) of a
    parameter of two or more dims over fsdp when fsdp divides it."""
    nd = len(shape)
    if nd < 2 or fsdp == 1:
        return (None,) * nd
    axis = int(np.argmax(shape))
    if shape[axis] % fsdp:
        return (None,) * nd
    return tuple("fsdp" if i == axis else None for i in range(nd))


def fsdp_tp_placement(name: str, shape: Sequence[int], tp: int, fsdp: int) -> Placement:
    """JAX's ``fsdp_tp_sharding`` (``param_sharding`` on a mesh whose model
    axis is larger than 1): the TP rule, then the fsdp split of the largest
    free dim."""
    spec = tp_placement(name, shape, tp)
    if all(s is None for s in spec):
        return fsdp_placement(shape, fsdp)
    if fsdp > 1 and len(shape) >= 2:
        free = [i for i, s in enumerate(spec) if s is None]
        if free:
            ax = max(free, key=lambda i: shape[i])
            if shape[ax] % fsdp == 0:
                spec = tuple("fsdp" if i == ax else s for i, s in enumerate(spec))
    return spec


def model_dim(spec: Placement) -> Optional[int]:
    """The dim a placement splits over the model axis, or None."""
    return spec.index("model") if "model" in spec else None


def shard_tensor(t: torch.Tensor, dim: Optional[int], rank: int, tp: int) -> torch.Tensor:
    """Rank `rank`'s contiguous part of `t` along `dim` (`t` itself when
    `dim` is None)."""
    if dim is None:
        return t
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).clone(memory_format=torch.contiguous_format)
