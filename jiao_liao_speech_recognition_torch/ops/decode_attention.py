"""K9: decode-step attention over head-major KV caches, bf16 or int8.

``grouped_decode_attention`` is the wrapper of the CUDA kernel in
``csrc/decode_attention.cu`` (which replaces the JAX package's
``ops/decode_attention.py::grouped_decode_attention``, both cache types;
the design note is in the .cu file). Int8 caches carry f32 per-position
scales [B, H, Tk] (``ops/quant.quantize_kv``) and count their launches on
``INT8_COUNTER``. ``decode_attention_plain`` is the same function in plain
PyTorch with the TPU kernel's rounding points (``_attend_head``); the
wrapper takes it only for CPU tensors.

Contract (the JAX kernel's): keys are valid on the prefix
[0, kv_lens[b]); the cache horizon Tk is a multiple of ``KERNEL_TK``
(caches are padded once, when they are built: ``pad_time_to_tk``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._build import SMEM_LIMIT, LaunchCounter, check_cuda, launch
from .numerics import full_f32

COUNTER = LaunchCounter("grouped_decode_attention")  # bf16 caches
INT8_COUNTER = LaunchCounter("grouped_decode_attention_int8")  # int8 caches
KERNEL_TK = 128  # key-horizon granularity of stored caches
HEAD_WIDTHS = (64, 128)  # the kernel's template instances
MAX_TQ = 8


def round_tk(t: int) -> int:
    """Key horizon rounded up to KERNEL_TK (cache sizing at build time)."""
    return -(-t // KERNEL_TK) * KERNEL_TK


def pad_time_to_tk(a: torch.Tensor, time_axis: int) -> torch.Tensor:
    """Zero-pad `a` along `time_axis` to KERNEL_TK (no-op when aligned).
    Build time only: padding per step would re-copy the whole cache."""
    t = a.shape[time_axis]
    extra = round_tk(t) - t
    if extra == 0:
        return a
    pads = [0, 0] * (a.dim() - 1 - time_axis % a.dim()) + [0, extra]
    return F.pad(a, pads)


def _check_tk(Tk: int) -> None:
    if Tk % KERNEL_TK:
        raise ValueError(f"Tk must be 128-padded at cache build time, got {Tk}")


def _quantized(k_scale, v_scale) -> bool:
    if (k_scale is None) != (v_scale is None):
        raise ValueError("int8 caches need both k_scale and v_scale")
    return k_scale is not None


def decode_attention_plain(qh, k, v, kv_lens, k_scale=None, v_scale=None):
    """qh [B, H, Tq, dh]; k/v [B, H, Tk, dh] bf16, or int8 with f32
    k_scale/v_scale [B, H, Tk]; kv_lens [B] -> f32 [B, H, Tq, dh]: q
    rounded to bf16 (the kernel's operand), f32 scores (times ks * 1/sqrt(dh)
    formed first, for int8), finfo.min past the length, f32 softmax, p
    (times vs for int8) rounded to bf16, f32 P.V."""
    quantized = _quantized(k_scale, v_scale)
    B, H, Tq, dh = qh.shape
    Tk = k.shape[2]
    _check_tk(Tk)
    lens = torch.clamp(torch.as_tensor(kv_lens, device=qh.device).to(torch.int64), max=Tk)
    lens = torch.broadcast_to(lens, (B,))
    valid = torch.arange(Tk, device=qh.device)[None, :] < lens[:, None]
    q = qh.to(torch.bfloat16).float()
    scale = float(np.float32(1 / np.sqrt(dh)))
    with full_f32():
        s = q @ k.to(torch.bfloat16).float().transpose(-1, -2)
        s = s * (k_scale.float()[:, :, None, :] * scale) if quantized else s * scale
        s = torch.where(valid[:, None, None, :], s, torch.finfo(torch.float32).min)
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
        if quantized:
            p = p * v_scale.float()[:, :, None, :]
        return p.to(torch.bfloat16).float() @ v.to(torch.bfloat16).float()


def decode_attention_fits(Tk: int, Tq: int = 1) -> bool:
    """True when the kernel's shared memory ([Tq'][Tk] f32 scores, the
    reduction scratch and [Tk] f32 value scales) fits one block."""
    tq = 1 if Tq <= 1 else 1 << (Tq - 1).bit_length()
    return (tq * Tk + 8 * tq + 8 * tq * max(HEAD_WIDTHS) + Tk) * 4 <= SMEM_LIMIT


def grouped_decode_attention(qh, k, v, kv_lens, k_scale=None, v_scale=None):
    """K9 wrapper -> f32 [B, H, Tq, dh]. CPU tensors take
    decode_attention_plain; CUDA tensors launch the kernel (bf16 caches, or
    int8 caches with f32 scales; Tq <= 8, dh in HEAD_WIDTHS, Tk % 128 == 0)
    or raise."""
    if qh.device.type == "cpu":
        return decode_attention_plain(qh, k, v, kv_lens, k_scale, v_scale)
    quantized = _quantized(k_scale, v_scale)
    B, H, Tq, dh = qh.shape
    Tk = k.shape[2]
    _check_tk(Tk)
    if dh not in HEAD_WIDTHS or Tq > MAX_TQ or not decode_attention_fits(Tk, Tq):
        raise ValueError(f"unsupported decode attention shape Tq={Tq} Tk={Tk} dh={dh}")
    cache_dtype = torch.int8 if quantized else torch.bfloat16
    for name, t in (("k", k), ("v", v)):
        if (t.device.type != "cuda" or t.dtype != cache_dtype or not t.is_contiguous()
                or tuple(t.shape) != (B, H, Tk, dh)):
            raise ValueError(f"{name}: expected a contiguous {cache_dtype} CUDA [B, H, Tk, dh] "
                             f"cache, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            check_cuda(name, t, torch.float32, 3)
            if tuple(t.shape) != (B, H, Tk):
                raise ValueError(f"{name}: expected [B, H, Tk], got {tuple(t.shape)}")
    q = qh.to(torch.bfloat16).contiguous()
    lens = torch.broadcast_to(torch.as_tensor(kv_lens, device=q.device).to(torch.int32), (B,))
    lens = lens.contiguous()
    out = torch.empty(B, H, Tq, dh, device=q.device, dtype=torch.float32)
    scale = float(np.float32(1 / np.sqrt(dh)))
    if quantized:
        launch("jl_decode_attention_int8", q.data_ptr(), k.data_ptr(), k_scale.data_ptr(),
               v.data_ptr(), v_scale.data_ptr(), lens.data_ptr(), out.data_ptr(),
               B, H, Tq, Tk, dh, scale)
        INT8_COUNTER.launches += 1
    else:
        launch("jl_decode_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
               out.data_ptr(), B, H, Tq, Tk, dh, scale)
        COUNTER.launches += 1
    return out
