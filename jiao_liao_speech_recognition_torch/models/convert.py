"""Weight bridge between JAX/flax CTC, Whisper and joint CTC/attention
parameters and the port's ``state_dict``, both ways (Whisper:
``whisper_params_to_state_dict`` and ``whisper_state_dict_to_params``;
joint: ``joint_params_to_state_dict`` and ``joint_state_dict_to_params``,
at the end of this file).

Two inputs are read:

* a flax param tree (nested dict of arrays), e.g. ``model.init(...)["params"]``
  of ``jiao_liao_speech_recognition_tpu.models.ctc_model.CTCEncoderModel``;
* the flat ``.npz`` layout ``bench.py::bench_parity`` writes: one array per
  leaf under the key ``"p_" + "/".join(path)`` (other keys are ignored).

Paths map one to one: ``block_i/...`` -> ``blocks.i...``; the WFDense
wrapper level ``dense`` is dropped (``q_proj/dense/kernel`` ->
``q_proj.kernel``); flax Conv kernels [k, in, out] become torch Conv1d
weights [out, in, k]. Dense kernels stay [in, out]. Adapter parameters
keep their flax names (``q_proj/adapter_wf/a`` -> ``q_proj.adapter_wf.a``,
``post_attn_slot/adapter_att/qkv_proj/kernel`` -> the same dotted).

The reverse (``state_dict_to_params``) restores the ``dense`` level under
the backbone's WFDense layers (the four attention projections and fc1/fc2)
and writes the same two layouts: ``write_npz_params`` (``p_a/b/c``) and
``adapter_arrays`` (the JAX ``save_adapter_only`` npz: key ``"/".join(path)``,
adapter leaves only) for each family (``FAMILIES``: ``family_of(model)``
names a model's). Dense layers inside an adapter (an Att adapter's
``qkv_proj`` / ``out_proj``, a bottleneck's ``down`` / ``up``) are flax
``nn.Dense`` and keep no ``dense`` level.
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



WF_DENSE = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")  # flax WFDense layers


def flax_path(key: str) -> Tuple[str, ...]:
    """state_dict key -> flax param path (inverse of ``torch_key``)."""
    parts = key.split(".")
    if parts[0] == "blocks":
        parts = [f"block_{parts[1]}"] + parts[2:]
        # backbone Dense params of a WFDense sit one level down, under "dense"
        if len(parts) >= 4 and parts[1] in ("self_attn", "mlp") and parts[2] in WF_DENSE \
                and parts[3] in ("kernel", "bias"):
            parts = parts[:3] + ["dense"] + parts[3:]
    if parts[0] == "subsample" and parts[-1] == "weight":
        parts[-1] = "kernel"
    return tuple(parts)


def state_dict_to_params(state: Mapping[str, torch.Tensor]) -> Dict:
    """state_dict -> nested flax param dict of f32 numpy arrays."""
    params: Dict = {}
    for key, t in state.items():
        arr = t.detach().cpu().float().numpy()
        path = flax_path(key)
        if path[0] == "subsample" and path[-1] == "kernel":
            arr = arr.transpose(2, 1, 0)  # [out, in, k] -> [k, in, out]
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return params


def write_npz_params(params: Mapping, path: str | Path) -> None:
    """Nested param dict -> the flat ``p_a/b/c`` npz (read_npz_params' layout)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{"p_" + "/".join(k): v for k, v in flatten_params(params).items()})


def adapter_arrays(state: Mapping[str, torch.Tensor], family: str = "ctc") -> Dict[str, np.ndarray]:
    """Adapter leaves only, keyed ``"/".join(flax path)`` as the JAX
    ``train/checkpoints.py::save_adapter_only`` writes them."""
    from .adapters import param_is_adapter

    flat = flatten_params(FAMILIES[family][1](state))
    return {"/".join(k): v for k, v in flat.items() if param_is_adapter(k)}


def family_of(model) -> str:
    """"whisper", "joint" or "ctc": the weight bridge a model takes."""
    from .joint import JointCTCAttentionModel
    from .whisper import WhisperModel

    if isinstance(model, WhisperModel):
        return "whisper"
    return "joint" if isinstance(model, JointCTCAttentionModel) else "ctc"


# --- Whisper -----------------------------------------------------------------
# flax tree {encoder: {conv1, conv2, block_i, ln_post}, decoder: {embed_tokens,
# embed_positions, block_i (+ cross_attn, cross_attn_ln), ln}}: every Dense
# under its WFDense's "dense" level; Conv kernels [k, in, out]. A quantized
# tree (ModelBundle.quantize) has "dense_q" {kernel_q int8, scale, bias} in
# the decoder and embed_tokens {embedding_q int8, scale}: the level is
# dropped the same way, and int8 arrays stay int8 both ways.

WHISPER_CONVS = ("conv1", "conv2")


def whisper_torch_key(path: Tuple[str, ...]) -> str:
    parts = []
    for p in path:
        if p in ("dense", "dense_q"):
            continue
        parts += ["blocks", p[len("block_"):]] if p.startswith("block_") else [p]
    if parts[-2] in WHISPER_CONVS and parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def _array(a) -> np.ndarray:
    """A writable f32 copy, or int8 for quantized leaves."""
    a = np.asarray(a)
    return np.array(a, dtype=np.int8 if a.dtype == np.int8 else np.float32)


def whisper_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX WhisperModel param tree -> state_dict of f32 (int8 where
    quantized) tensors for the port's WhisperModel."""
    state = {}
    for path, arr in flatten_params(params).items():
        arr = _array(arr)
        if path[-2] in WHISPER_CONVS and path[-1] == "kernel":
            arr = arr.transpose(2, 1, 0)  # [k, in, out] -> [out, in, k]
        state[whisper_torch_key(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def whisper_flax_path(key: str, quantized: bool = False) -> Tuple[str, ...]:
    """state_dict key -> flax path; `quantized`: the key's layer is an
    Int8Dense (its leaves go under "dense_q")."""
    parts = key.split(".")
    out = []
    i = 0
    while i < len(parts):
        if parts[i] == "blocks":
            out.append(f"block_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    if quantized:
        out.insert(len(out) - 1, "dense_q")
    elif out[-2] in WF_DENSE and out[-1] in ("kernel", "bias") \
            and not any(p.startswith("adapter_") for p in out):
        out.insert(len(out) - 1, "dense")
    if out[-2] in WHISPER_CONVS and out[-1] == "weight":
        out[-1] = "kernel"
    return tuple(out)


def whisper_state_dict_to_params(state: Mapping[str, torch.Tensor]) -> Dict:
    """Port WhisperModel state_dict -> nested flax param dict (f32 numpy;
    int8 leaves stay int8)."""
    int8_layers = {k.rsplit(".", 1)[0] for k in state if k.endswith(".kernel_q")}
    params: Dict = {}
    for key, t in state.items():
        arr = _array(t.detach().cpu().to(torch.int8 if t.dtype == torch.int8 else torch.float32))
        path = whisper_flax_path(key, key.rsplit(".", 1)[0] in int8_layers)
        if path[-2] in WHISPER_CONVS and path[-1] == "kernel":
            arr = arr.transpose(2, 1, 0)
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return params


# --- joint CTC/attention -------------------------------------------------------
# flax tree {subsample: {conv1, conv2}, enc_block_i, enc_ln, ctc_head,
# embed_tokens, dec_block_i (+ cross_attn, cross_attn_ln), dec_ln}: the
# attention projections and fc1/fc2 of every block under their WFDense's
# "dense" level (the WF inserts beside it as adapter_wf); Conv kernels
# [k, in, out]. The port's modules: enc_blocks.i / dec_blocks.i.

JOINT_BLOCKS = {"enc_block_": "enc_blocks", "dec_block_": "dec_blocks"}


def joint_torch_key(path: Tuple[str, ...]) -> str:
    parts = []
    for p in path:
        if p == "dense":
            continue
        for flax, torch_name in JOINT_BLOCKS.items():
            if p.startswith(flax):
                parts += [torch_name, p[len(flax):]]
                break
        else:
            parts.append(p)
    if parts[0] == "subsample" and parts[-1] == "kernel":
        parts[-1] = "weight"
    return ".".join(parts)


def joint_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX JointCTCAttentionModel param tree -> state_dict of f32 tensors
    for the port's JointCTCAttentionModel."""
    state = {}
    for path, arr in flatten_params(params).items():
        arr = np.array(arr, dtype=np.float32)
        if path[0] == "subsample" and path[-1] == "kernel":
            arr = arr.transpose(2, 1, 0)  # [k, in, out] -> [out, in, k]
        state[joint_torch_key(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def joint_flax_path(key: str) -> Tuple[str, ...]:
    """state_dict key -> flax param path (inverse of ``joint_torch_key``)."""
    parts = key.split(".")
    names = {v: k for k, v in JOINT_BLOCKS.items()}
    if parts[0] in names:
        parts = [names[parts[0]] + parts[1]] + parts[2:]
        if len(parts) >= 4 and parts[1] in ("self_attn", "cross_attn", "mlp") \
                and parts[2] in WF_DENSE and parts[3] in ("kernel", "bias"):
            parts = parts[:3] + ["dense"] + parts[3:]
    if parts[0] == "subsample" and parts[-1] == "weight":
        parts[-1] = "kernel"
    return tuple(parts)


def joint_state_dict_to_params(state: Mapping[str, torch.Tensor]) -> Dict:
    """Port JointCTCAttentionModel state_dict -> nested flax param dict of
    f32 numpy arrays."""
    params: Dict = {}
    for key, t in state.items():
        arr = t.detach().cpu().float().numpy()
        path = joint_flax_path(key)
        if path[0] == "subsample" and path[-1] == "kernel":
            arr = arr.transpose(2, 1, 0)
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return params


# family -> (flax path -> state_dict key, state_dict -> flax tree)
FAMILIES = {
    "ctc": (torch_key, state_dict_to_params),
    "whisper": (whisper_torch_key, whisper_state_dict_to_params),
    "joint": (joint_torch_key, joint_state_dict_to_params),
}
