"""K6 / K8: flash attention forward (with log-sum-exp) and its backward.

``flash_forward`` and ``flash_backward`` are the wrappers of the CUDA
kernels in ``csrc/flash_attention.cu``, which replace the JAX package's
``ops/flash_attention.py`` forward and backward kernels. On the H100 both
are TMA + wgmma kernels (sm_90a): one thread of a producer warpgroup
streams K/V (forward, 128-key tiles) or K/V and Q/dO (backward, 64-row
tiles) through two mbarrier-counted stages of 4-D tensor maps over the
strided views, and two consumer warpgroups of 64 rows each run the products
with P and dS fed back from registers; the backward is two launches without
atomics (dQ; dK and dV), so it is repeatable bit for bit. The design note is in the .cu
file. ``flash_forward_plain`` / ``flash_backward_plain`` are the same
functions in plain PyTorch; the wrappers take them only for tensors on the
CPU. ``FlashAttention`` is the ``torch.autograd.Function`` that ties the
two together, and ``flash_attention`` / ``flash_attention_packed`` are the
public entry points with the JAX functions' signatures.

Layouts: q [B, Tq, H, dh] and k/v [B, Tk, H, dh] with heads contiguous and
any batch and time strides that the tensor maps take (multiples of 8
elements, 16-byte-aligned data, T >= 1), or head-packed [B, T, H*dh] - the
same bytes. lse is f32 [B*H, Tq]. P is rounded to the compute dtype before
P.V, as the kernel rounds its tensor-core operand; the backward's plain
version stays in f32 (the kernel carries P and dS as bf16 hi + lo pairs).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._build import LaunchCounter, launch, refuse_grad
from .numerics import full_f32

COUNTER = LaunchCounter("flash_attention")  # K6
BWD_COUNTER = LaunchCounter("flash_attention_backward")  # K8
HEAD_WIDTHS = (64, 128)  # the kernels' template instances
NEG = -1e30  # the JAX kernels' mask value
LSE_FLOOR = -1e29  # the backward's clamp of the saved lse
MAX_STRIDE = 2 ** 39  # elements: a tensor map's byte strides stay below 2^40
# csrc/flash_attention.cu's tiles: rows a block owns (kRows), keys of a
# forward tile (kFwdKeys), rows of a streamed backward tile (kBox)
BLOCK_ROWS, FWD_KEYS, BWD_TILE = 128, 128, 64


def stats_rows(Tq: int) -> int:
    """Tp: the backward's scratch rows a head, Tq rounded up to a block's
    BLOCK_ROWS."""
    return -(-Tq // BLOCK_ROWS) * BLOCK_ROWS


def _scale(dh: int) -> float:
    return float(np.float32(1.0 / np.sqrt(dh)))


def _lengths(kv_lengths, B: int, Tk: int, device) -> torch.Tensor:
    lens = torch.as_tensor(kv_lengths, device=device).to(torch.int64)
    return torch.broadcast_to(lens, (B,)).clamp(0, Tk)


def _kernel_lengths(kv_lengths, B: int, Tk: int, device) -> torch.Tensor:
    """int32 [B] lengths for a kernel, which clamps them to [0, Tk] itself:
    a tensor that already is one passes as it is (no conversion launches)."""
    if (isinstance(kv_lengths, torch.Tensor) and kv_lengths.dtype == torch.int32
            and kv_lengths.shape == (B,) and kv_lengths.device == device
            and kv_lengths.is_contiguous()):
        return kv_lengths
    return _lengths(kv_lengths, B, Tk, device).to(torch.int32).contiguous()


def _valid(lens, Tq: int, Tk: int, causal: bool, device) -> torch.Tensor:
    """[B, 1, Tq, Tk] bool: key < kv_len (and key <= query if causal)."""
    keys = torch.arange(Tk, device=device)
    valid = (keys[None, :] < lens[:, None])[:, None, None, :]
    if causal:
        valid = valid & (keys[None, :] <= torch.arange(Tq, device=device)[:, None])
    return valid


def flash_forward_plain(q, k, v, kv_lengths, causal: bool = False):
    """-> (out [B, Tq, H, dh] in q.dtype, lse f32 [B*H, Tq]). Rows with no
    valid key give out = 0 and lse = -1e30, as the kernels' skipped tiles do."""
    B, Tq, H, dh = q.shape
    Tk = k.shape[1]
    lens = _lengths(kv_lengths, B, Tk, q.device)
    valid = _valid(lens, Tq, Tk, causal, q.device)
    with full_f32():
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(dh)
        s = torch.where(valid, s, NEG)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(valid, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        acc = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), v.float())
    out = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l)).reshape(B * H, Tq)
    return out, lse


def flash_backward_plain(q, k, v, kv_lengths, out, lse, dout, causal: bool = False):
    """-> (dq, dk, dv) in f32 from the saved out / lse: P = exp(s - lse) on
    valid keys, delta = rowsum(dO * O), dS = P * (dO V^T - delta)."""
    B, Tq, H, dh = q.shape
    Tk = k.shape[1]
    scale = _scale(dh)
    lens = _lengths(kv_lengths, B, Tk, q.device)
    valid = _valid(lens, Tq, Tk, causal, q.device)
    qf, kf, vf, do = q.float(), k.float(), v.float(), dout.float()
    lse4 = lse.reshape(B, H, Tq, 1).clamp_min(LSE_FLOOR)
    with full_f32():
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        p = torch.where(valid, torch.exp(s - lse4), 0.0)
        delta = (do * out.float()).sum(-1).permute(0, 2, 1)[..., None]  # [B, H, Tq, 1]
        dp = torch.einsum("bqhd,bkhd->bhqk", do, vf)
        ds = p * (dp - delta)
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
        dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    return dq, dk, dv


def _check(name, t, B: int, H: int, dh: int):
    """Raise unless `t` is a bf16 [B, T, H, dh] tensor that the kernels' 4-D
    tensor maps take (the device is _on_cuda's to check, after every
    layout, so meta tensors exercise each refusal)."""
    if t.dtype != torch.bfloat16 or t.dim() != 4:
        raise ValueError(f"{name}: expected a bf16 CUDA [B, T, H, dh] tensor, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if t.shape[0] != B or t.shape[2] != H or t.shape[3] != dh:
        raise ValueError(f"{name}: shape {tuple(t.shape)} does not match B={B} H={H} dh={dh}")
    if min(t.shape) < 1:
        raise ValueError(f"{name}: empty tensor {tuple(t.shape)}")
    if t.stride(3) != 1 or (H > 1 and t.stride(2) != dh):
        raise ValueError(f"{name}: heads must be contiguous (strides {t.stride()})")
    _, sb, st = _strided(t)
    if sb % 8 or st % 8 or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned (strides {t.stride()})")
    if sb <= 0 or st <= 0 or max(sb, st) >= MAX_STRIDE:
        raise ValueError(f"{name}: strides {t.stride()} are not a tensor map's")


def _on_cuda(**tensors):
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _shape_checks(q, k, v):
    B, Tq, H, dh = q.shape
    if dh not in HEAD_WIDTHS:
        raise ValueError(f"head width {dh}: the kernels take {HEAD_WIDTHS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, B, H, dh)
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    return B, Tq, H, dh, k.shape[1]


def _strided(t):
    """-> (pointer, batch stride, time stride) in elements; a dim of size 1
    takes the stride a packed tensor would have (the map never steps it)."""
    B, T, H, dh = t.shape
    st = t.stride(1) if T > 1 else H * dh
    sb = t.stride(0) if B > 1 else T * st
    return (t.data_ptr(), sb, st)


def flash_forward(q, k, v, kv_lengths, causal: bool = False):
    """K6 wrapper -> (out, lse). CPU tensors take flash_forward_plain; CUDA
    tensors launch the kernel (bf16, dh in HEAD_WIDTHS) or raise. Gradients
    go through FlashAttention, never through this call."""
    if q.device.type == "cpu":
        return flash_forward_plain(q, k, v, kv_lengths, causal)
    refuse_grad("flash_forward", q, k, v)
    B, Tq, H, dh, Tk = _shape_checks(q, k, v)
    _on_cuda(q=q, k=k, v=v)
    lens = _kernel_lengths(kv_lengths, B, Tk, q.device)
    out = torch.empty(B, Tq, H, dh, device=q.device, dtype=q.dtype)
    lse = torch.empty(B * H, Tq, device=q.device, dtype=torch.float32)
    launch(
        "jl_flash_fwd", *_strided(q), *_strided(k), *_strided(v), lens.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, H, Tq, Tk, dh, int(causal), _scale(dh),
    )
    COUNTER.launches += 1
    return out, lse


def flash_backward(q, k, v, kv_lengths, out, lse, dout, causal: bool = False):
    """K8 wrapper -> (dq, dk, dv) in the primal dtype. CPU tensors take
    flash_backward_plain; CUDA tensors launch the two kernels or raise."""
    if q.device.type == "cpu":
        dq, dk, dv = flash_backward_plain(q, k, v, kv_lengths, out, lse, dout, causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    B, Tq, H, dh, Tk = _shape_checks(q, k, v)
    out = out.contiguous()
    dout = dout.to(q.dtype).contiguous()
    if (out.shape != q.shape or out.dtype != q.dtype or lse.shape != (B * H, Tq)
            or lse.dtype != torch.float32):
        raise ValueError("out / lse do not match q")
    _check("out", out, B, H, dh)  # read, like dout, in 16-byte vectors
    _check("dout", dout, B, H, dh)
    lse = lse.contiguous()
    _on_cuda(q=q, k=k, v=v, out=out, dout=dout, lse=lse)
    lens = _kernel_lengths(kv_lengths, B, Tk, q.device)
    dq = torch.empty(B, Tq, H, dh, device=q.device, dtype=q.dtype)
    dk = torch.empty(B, Tk, H, dh, device=q.device, dtype=q.dtype)
    dv = torch.empty_like(dk)
    # launch 1 writes each row's base-2 lse and delta here for launch 2
    stats = torch.empty(B * H, 2, stats_rows(Tq), device=q.device, dtype=torch.float32)
    launch(
        "jl_flash_bwd", *_strided(q), *_strided(k), *_strided(v), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), lens.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), stats.data_ptr(), B, H, Tq, Tk, dh, int(causal), _scale(dh),
    )
    BWD_COUNTER.launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); the forward saves (q, k, v, out, lse) and
    the backward is K8. With ``kernels=False`` both directions take the
    plain versions (the plain-flash path a kernel run is compared with)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, causal, kernels):
        fwd = flash_forward if kernels else flash_forward_plain
        out, lse = fwd(q, k, v, kv_lengths, causal)
        ctx.save_for_backward(q, k, v, kv_lengths, out, lse)
        ctx.causal, ctx.kernels = causal, kernels
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_lengths, out, lse = ctx.saved_tensors
        if ctx.kernels:
            dq, dk, dv = flash_backward(q, k, v, kv_lengths, out, lse, dout, ctx.causal)
        else:
            grads = flash_backward_plain(q, k, v, kv_lengths, out, lse, dout, ctx.causal)
            dq, dk, dv = (g.to(t.dtype) for g, t in zip(grads, (q, k, v)))
        return dq, dk, dv, None, None, None


def _lengths_from(mask, kv_lengths, B: int, Tk: int, device) -> torch.Tensor:
    """The JAX rule: explicit lengths win; else a key-validity mask
    [B|1, 1, 1, Tk] is summed; no mask means every key is valid."""
    if kv_lengths is not None:
        return _kernel_lengths(kv_lengths, B, Tk, device)
    if mask is None:
        return torch.full((B,), Tk, dtype=torch.int32, device=device)
    if mask.dim() != 4 or mask.shape[1] != 1 or mask.shape[2] != 1:
        raise NotImplementedError("flash path needs a key-validity mask")
    return torch.broadcast_to(mask, (B, 1, 1, Tk))[:, 0, 0, :].sum(-1).to(torch.int32)


def flash_attention(q, k, v, mask: Optional[torch.Tensor] = None, causal: bool = False,
                    kv_lengths: Optional[torch.Tensor] = None,
                    kernels: bool = True) -> torch.Tensor:
    """Flash attention over [B, T, H, dh]; differentiable through K8.
    kernels=False takes the plain versions on any device."""
    B, _, _, _ = q.shape
    lens = _lengths_from(mask, kv_lengths, B, k.shape[1], q.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, lens, causal, kernels)
    return (flash_forward if kernels else flash_forward_plain)(q, k, v, lens, causal)[0]


def flash_attention_packed(q, k, v, num_heads: int, mask: Optional[torch.Tensor] = None,
                           causal: bool = False, kv_lengths: Optional[torch.Tensor] = None,
                           kernels: bool = True) -> torch.Tensor:
    """Flash attention on head-packed [B, T, H*dh] layouts: a view as
    [B, T, H, dh] (no copy) through flash_attention."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    dh = D // num_heads
    out = flash_attention(
        q.view(B, Tq, num_heads, dh), k.view(B, Tk, num_heads, dh),
        v.view(B, Tk, num_heads, dh), mask, causal, kv_lengths, kernels,
    )
    return out.reshape(B, Tq, D)
