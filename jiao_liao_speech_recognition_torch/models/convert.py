"""Weight bridge: JAX/flax CTC parameters -> the port's ``state_dict``.

Two inputs are read:

* a flax param tree (nested dict of arrays), e.g. ``model.init(...)["params"]``
  of ``jiao_liao_speech_recognition_tpu.models.ctc_model.CTCEncoderModel``;
* the flat ``.npz`` layout ``bench.py::bench_parity`` writes: one array per
  leaf under the key ``"p_" + "/".join(path)`` (other keys are ignored).

Paths map one to one: ``block_i/...`` -> ``blocks.i...``; the WFDense
wrapper level ``dense`` is dropped (``q_proj/dense/kernel`` ->
``q_proj.kernel``); flax Conv kernels [k, in, out] become torch Conv1d
weights [out, in, k]. Dense kernels stay [in, out].
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def flatten_params(params: Mapping) -> Dict[Tuple[str, ...], np.ndarray]:
    out: Dict[Tuple[str, ...], np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (str(k),))
        else:
            out[path] = np.asarray(node)

    walk(params, ())
    return out


def torch_key(path: Tuple[str, ...]) -> str:
    parts = [p for p in path if p != "dense"]
    if parts[0].startswith("block_"):
        parts = ["blocks", parts[0][len("block_"):]] + parts[1:]
    if parts[0] == "subsample" and parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax tree -> state_dict of f32 tensors for CTCEncoderModel."""
    state = {}
    for path, arr in flatten_params(params).items():
        arr = np.array(arr, dtype=np.float32)  # a writable copy
        if path[0] == "subsample" and path[-1] == "kernel":
            arr = arr.transpose(2, 1, 0)  # [k, in, out] -> [out, in, k]
        state[torch_key(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def read_npz_params(path: str | Path) -> Dict:
    """Flat ``p_a/b/c`` npz -> nested param dict of numpy arrays."""
    params: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            if not key.startswith("p_"):
                continue
            node = params
            parts = key[2:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return params

