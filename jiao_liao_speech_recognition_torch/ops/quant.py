"""Weight-only int8 serving, the PyTorch twin of the JAX package's
``ops/quant.py``.

* ``quantize_int8`` / ``quantize_kv``: per-channel and per-position
  symmetric int8, plain math, bitwise the JAX functions (f32 division by
  the safe scale, round half to even, clip to +-127; a zero channel keeps
  scale 0).
* K10, ``int8_matmul``: y = (x . q) * s (+ bias) for x [.., d_in], q
  int8 [d_in, d_out], s f32 [d_out] and an optional bias [d_out]. At most
  ``MAX_KERNEL_ROWS`` rows take ``int8_gemv``, the wrapper of
  ``jl_int8_matmul`` (``csrc/quant.cu``, one launch that replaces
  ``_int8_matmul_pallas`` and the caller's bias add); longer inputs take
  the JAX package's XLA function (bf16 operands, an f32 product, * s, one
  rounding), then the bias, as ``int8_matmul_plain`` does.
* K10's row-parallel partial, ``int8_row_product``: a tensor-parallel
  rank's f32 share (x_r . q_r) * s of a row-parallel layer (its input
  rows of q, the whole column's scale), neither rounded nor biased; the
  group's all-reduce sums the shares, then the layer rounds once and adds
  its bias once (``int8_finish``, K10's rounding rule, which
  ``int8_matmul`` also takes; ``models/layers.Int8Dense``). At most
  ``MAX_KERNEL_ROWS`` rows take ``int8_row_partial``
  (``jl_int8_row_partial``: K10's kernel with an f32 epilogue); longer
  inputs, and ``kernels=False``, take ``int8_row_partial_plain``.
* K11, ``int8_tied_logits``: f32 logits (x . q^T) * s against a row-major
  int8 [V, D] table with per-vocab-row scales. At most ``MAX_KERNEL_ROWS``
  rows take ``int8_logits`` (``jl_int8_tied_logits``, replacing
  ``_int8_tied_logits_pallas``; ``jl_int8_tied_logits_ragged`` where D %
  16 != 0); longer inputs take
  ``int8_tied_logits_dequant``, the JAX package's XLA function, which
  rounds the dequantized table to bf16 before the product (the kernel
  scales after it).
* ``int8_decode_attention``: the shim over K9's int8 half
  (``ops/decode_attention.py``).
* ``int8_kv_write``: one decode step's K and V rows of an int8 self cache
  quantized (``quantize_kv``) and written at each row's position, in one
  launch of ``jl_int8_kv_write`` (the port's own kernel: the JAX package's
  XLA fuses ``quantize_kv`` and the cache update inside its loop);
  ``int8_kv_write_plain`` is quantize_kv plus four ``update_cache_rows``.

A wrapper takes its kernel's plain version for CPU tensors only; a CUDA
tensor launches the kernel or raises. ``kernels=False`` picks the plain
versions on the card too (the comparisons in chip_smoke.py). Products
outside the kernels leave cuBLAS in f32 (``torch.mm(..., out_dtype=f32)``)
or are f32 products of bf16 values on the CPU, so each rounds once, as
XLA's ``preferred_element_type=f32``.
"""

from __future__ import annotations

import math

import torch

from .._build import LaunchCounter, check_aligned, check_cuda, launch, refuse_grad
from .decode_attention import (
    KERNEL_TK,
    decode_attention_plain,
    grouped_decode_attention,
    pad_time_to_tk,
)
from .numerics import full_f32

MATMUL_COUNTER = LaunchCounter("int8_matmul")  # K10
ROW_PARTIAL_COUNTER = LaunchCounter("int8_row_partial")  # K10's row-parallel partial
LOGITS_COUNTER = LaunchCounter("int8_tied_logits")  # K11
KV_WRITE_COUNTER = LaunchCounter("int8_kv_write")  # the int8 self-cache write
# rows beyond this take the dequantizing product: long (teacher-forced)
# inputs are compute-bound, where reading the weights once more is cheap
MAX_KERNEL_ROWS = 64


def quantize_int8(w: torch.Tensor, amax: torch.Tensor | None = None):
    """Per-output-channel int8: w [d_in, d_out] -> (q int8 [d_in, d_out],
    scale f32 [d_out]) with w ~= q * scale[None, :]. `amax` [d_out], when
    given, is each channel's max |w| over rows that `w` holds only part of
    (a tensor-parallel rank's rows of a row-parallel layer)."""
    w = w.float()
    scale = (w.abs().amax(dim=0) if amax is None else amax.float()) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(w / safe[None, :]), -127, 127).to(torch.int8)
    return q, scale


def quantize_kv(a: torch.Tensor):
    """Per-position int8 for KV caches: a [..., T, dh] -> (q int8 of a's
    shape, scale f32 [..., T]) with a ~= q * scale[..., None]."""
    a = a.float()
    scale = a.abs().amax(dim=-1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(a / safe[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 operands with an f32 result, rounded once."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    with full_f32():  # products of bf16 values are exact in f32
        return a.float() @ b.float()


def _rows(x: torch.Tensor) -> int:
    return math.prod(x.shape[:-1])


# --- K10 --------------------------------------------------------------------


def _scaled_product(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 (x_bf16 . q_bf16) * scale, not yet rounded (q's int8 values are
    exact in bf16)."""
    return _mm_f32(x2.to(torch.bfloat16), q.to(torch.bfloat16)) * scale.float()


def int8_finish(y: torch.Tensor, dtype: torch.dtype,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """K10's rounding rule, stated once: the f32 scaled product y [..., d_out]
    (a split row layer's summed partials too) -> `dtype` as int8_matmul
    gives it: at most MAX_KERNEL_ROWS rows rounded to bf16 first (K10's
    epilogue), then cast to `dtype`, then + bias in `dtype`."""
    if _rows(y) <= MAX_KERNEL_ROWS:
        y = y.to(torch.bfloat16)
    y = y.to(dtype)
    return y if bias is None else y + bias.to(dtype)


def int8_matmul_plain(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """x2 [R, d_in] -> bf16 [R, d_out]: the scaled f32 product rounded to
    bf16 once, then + bias (bf16) and rounded again."""
    return int8_finish(_scaled_product(x2, q, scale), torch.bfloat16, bias)


def int8_gemv(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """K10 wrapper -> bf16 [R, d_out]. CPU tensors take int8_matmul_plain;
    CUDA tensors launch the kernel (R <= MAX_KERNEL_ROWS, d_in % 8 == 0,
    d_out % 16 == 0, bias bf16 or None) or raise. Allocates only y."""
    if x2.device.type == "cpu":
        return int8_matmul_plain(x2, q, scale, bias)
    refuse_grad("int8_gemv", x2)
    x2 = x2.to(torch.bfloat16).contiguous()
    if x2.data_ptr() % 16:  # the kernel reads x in 16-byte vectors
        x2 = x2.clone()
    check_cuda("q", q, torch.int8, 2)
    check_cuda("scale", scale, torch.float32, 1)
    R, d_in = x2.shape
    d_out = q.shape[1]
    if bias is not None:
        check_cuda("bias", bias, torch.bfloat16, 1)
    if (not 0 < R <= MAX_KERNEL_ROWS or q.shape[0] != d_in or d_in % 8 or d_out % 16
            or scale.shape[0] != d_out or (bias is not None and bias.shape[0] != d_out)):
        raise ValueError(f"unsupported int8 matmul shape R={R} q={tuple(q.shape)}")
    y = torch.empty(R, d_out, device=x2.device, dtype=torch.bfloat16)
    launch("jl_int8_matmul", x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
           0 if bias is None else bias.data_ptr(), y.data_ptr(), R, d_in, d_out)
    MATMUL_COUNTER.launches += 1
    return y


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                kernels: bool = True, bias: torch.Tensor | None = None) -> torch.Tensor:
    """y = x . (q * scale) + bias for x [..., d_in] -> [..., d_out] in
    x.dtype, the bias (optional) added in x.dtype after the product's
    rounding, as the JAX package's caller adds it: K10 (or its plain
    version with kernels=False) for at most MAX_KERNEL_ROWS rows, the bias
    folded into it for a bf16 x; longer inputs take the plain product."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not kernels or _rows(x) > MAX_KERNEL_ROWS:
        y = int8_finish(_scaled_product(x2, q, scale), x.dtype, bias)
    elif x.dtype == torch.bfloat16:  # the bias folds into K10's epilogue
        y = int8_gemv(x2, q, scale, bias)
    else:
        y = int8_finish(int8_gemv(x2, q, scale), x.dtype, bias)
    return y.reshape(*lead, q.shape[1])


# --- K10's row-parallel partial ------------------------------------------------


def int8_row_partial_plain(x2: torch.Tensor, q: torch.Tensor,
                           scale: torch.Tensor) -> torch.Tensor:
    """x2 [R, d_in] -> f32 [R, d_out]: (x_bf16 . q_bf16) * scale, neither
    rounded nor biased."""
    return _scaled_product(x2, q, scale)


def int8_row_partial(x2: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Wrapper of jl_int8_row_partial -> f32 [R, d_out]. CPU tensors take
    int8_row_partial_plain; CUDA tensors launch the kernel (K10's shape
    rule: R <= MAX_KERNEL_ROWS, d_in % 8 == 0, d_out % 16 == 0) or raise.
    Allocates only the output."""
    if x2.device.type == "cpu":
        return int8_row_partial_plain(x2, q, scale)
    refuse_grad("int8_row_partial", x2)
    x2 = x2.to(torch.bfloat16).contiguous()
    if x2.data_ptr() % 16:  # the kernel reads x in 16-byte vectors
        x2 = x2.clone()
    check_cuda("q", q, torch.int8, 2)
    check_cuda("scale", scale, torch.float32, 1)
    R, d_in = x2.shape
    d_out = q.shape[1]
    if (not 0 < R <= MAX_KERNEL_ROWS or q.shape[0] != d_in or d_in % 8 or d_out % 16
            or scale.shape[0] != d_out):
        raise ValueError(f"unsupported int8 row partial shape R={R} q={tuple(q.shape)}")
    y = torch.empty(R, d_out, device=x2.device, dtype=torch.float32)
    launch("jl_int8_row_partial", x2.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
           R, d_in, d_out)
    ROW_PARTIAL_COUNTER.launches += 1
    return y


def int8_row_product(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                     kernels: bool = True) -> torch.Tensor:
    """A row-parallel int8 layer's f32 partial for x [..., d_in] ->
    [..., d_out]: the kernel (its plain version with kernels=False) for at
    most MAX_KERNEL_ROWS rows, the plain product beyond."""
    x2 = x.reshape(-1, x.shape[-1])
    fn = int8_row_partial if kernels and _rows(x) <= MAX_KERNEL_ROWS else int8_row_partial_plain
    return fn(x2, q, scale).reshape(*x.shape[:-1], q.shape[1])


# --- K11 --------------------------------------------------------------------


def int8_tied_logits_plain(x2: torch.Tensor, q_vd: torch.Tensor,
                           scale_v: torch.Tensor) -> torch.Tensor:
    """x2 [R, D] -> f32 [R, V]: f32 (x_bf16 . q_bf16^T), then * scale_v."""
    y = _mm_f32(x2.to(torch.bfloat16), q_vd.to(torch.bfloat16).t())
    return y * scale_v.float()


def int8_tied_logits_dequant(x2: torch.Tensor, q_vd: torch.Tensor,
                             scale_v: torch.Tensor) -> torch.Tensor:
    """The JAX package's XLA function: the table dequantized and rounded to
    bf16 first, then an f32 product -> f32 [R, V]."""
    w = (q_vd.float() * scale_v.float()[:, None]).to(torch.bfloat16)
    return _mm_f32(x2.to(torch.bfloat16), w.t())


def int8_logits(x2: torch.Tensor, q_vd: torch.Tensor, scale_v: torch.Tensor) -> torch.Tensor:
    """K11 wrapper -> f32 [R, V]. CPU tensors take int8_tied_logits_plain;
    CUDA tensors launch a kernel (R <= MAX_KERNEL_ROWS) or raise. The shape
    rule: D % 16 == 0 (the table's row pitch fits a tensor map) takes the
    persistent TMA kernel (``jl_int8_tied_logits``); any other D the
    ragged kernel (``jl_int8_tied_logits_ragged``). Both count on
    LOGITS_COUNTER."""
    if x2.device.type == "cpu":
        return int8_tied_logits_plain(x2, q_vd, scale_v)
    refuse_grad("int8_logits", x2)
    x2 = x2.to(torch.bfloat16).contiguous()
    if x2.data_ptr() % 16:  # x is staged in 16-byte vectors
        x2 = x2.clone()
    check_cuda("q_vd", q_vd, torch.int8, 2)
    check_cuda("scale_v", scale_v, torch.float32, 1)
    R, D = x2.shape
    V = q_vd.shape[0]
    if not 0 < R <= MAX_KERNEL_ROWS or q_vd.shape[1] != D or scale_v.shape[0] != V:
        raise ValueError(f"unsupported int8 logits shape R={R} D={D} table={tuple(q_vd.shape)}")
    tma = D % 16 == 0
    if tma:
        check_aligned("int8_logits", q_vd)  # a tensor map's base
    out = torch.empty(R, V, device=x2.device, dtype=torch.float32)
    launch("jl_int8_tied_logits" if tma else "jl_int8_tied_logits_ragged", x2.data_ptr(),
           q_vd.data_ptr(), scale_v.data_ptr(), out.data_ptr(), R, V, D)
    LOGITS_COUNTER.launches += 1
    return out


def int8_tied_logits(x: torch.Tensor, q_vd: torch.Tensor, scale_v: torch.Tensor,
                     kernels: bool = True) -> torch.Tensor:
    """f32 logits [R, V] of x [R, D] against the row-major int8 table: K11
    (or its plain version with kernels=False) for at most MAX_KERNEL_ROWS
    rows, else int8_tied_logits_dequant. (The JAX package also sends
    D % 128 != 0 to its XLA path, a TPU lane rule; K11 takes any D.)"""
    if x.shape[0] > MAX_KERNEL_ROWS:
        return int8_tied_logits_dequant(x, q_vd, scale_v)
    return (int8_logits if kernels else int8_tied_logits_plain)(x, q_vd, scale_v)


# --- the int8 self-cache write --------------------------------------------------


def int8_kv_write_plain(k: torch.Tensor, v: torch.Tensor, cache: dict, index) -> None:
    """quantize_kv of one step's rows k, v [B, H, 1, dh], written into the
    int8 head-major self cache (``k``, ``v`` int8 [B, H, T, dh], ``k_scale``,
    ``v_scale`` f32 [B, H, T]) at `index` (an int or [B] positions) by
    update_cache_rows."""
    from ..models.layers import update_cache_rows

    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    for name, new in (("k", kq), ("k_scale", ks), ("v", vq), ("v_scale", vs)):
        update_cache_rows(cache[name], new, index, 2)


def int8_kv_write(k: torch.Tensor, v: torch.Tensor, cache: dict, index) -> None:
    """Wrapper of jl_int8_kv_write: int8_kv_write_plain in one launch, the
    same bits. CPU tensors take the plain version; CUDA tensors launch the
    kernel (k, v bf16 or f32 [B, H, 1, dh] with dh contiguous and equal
    strides, dh % 32 == 0, dh <= 256; contiguous caches) or raise. An int
    `index` is filled on the device; a tensor one is read there, so a CUDA
    graph captures the call."""
    if k.device.type == "cpu":
        return int8_kv_write_plain(k, v, cache, index)
    refuse_grad("int8_kv_write", k, v)
    B, H, Tq, dh = k.shape
    kq, ks, vq, vs = cache["k"], cache["k_scale"], cache["v"], cache["v_scale"]
    for name, t, dt, nd in (("k", kq, torch.int8, 4), ("v", vq, torch.int8, 4),
                            ("k_scale", ks, torch.float32, 3), ("v_scale", vs, torch.float32, 3)):
        check_cuda(name, t, dt, nd)
    T = kq.shape[2]
    if (Tq != 1 or v.shape != k.shape or v.dtype != k.dtype or v.stride() != k.stride()
            or k.stride(3) != 1 or k.dtype not in (torch.bfloat16, torch.float32)
            or dh % 32 or dh > 256 or tuple(kq.shape) != (B, H, T, dh)
            or vq.shape != kq.shape or tuple(ks.shape) != (B, H, T) or vs.shape != ks.shape):
        raise ValueError(f"unsupported int8 cache write k={tuple(k.shape)} {k.dtype} "
                         f"cache={tuple(kq.shape)}")
    if torch.is_tensor(index):
        pos = index.to(k.device, torch.int64).reshape(-1).expand(B).contiguous()
    else:
        pos = torch.full((B,), int(index), dtype=torch.int64, device=k.device)
    launch("jl_int8_kv_write", k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1),
           kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(), pos.data_ptr(),
           B, H, T, dh, int(k.dtype == torch.float32))
    KV_WRITE_COUNTER.launches += 1


# --- K9, int8 half ------------------------------------------------------------


def int8_decode_attention(qh, kq, ks, vq, vs, kv_lens, kernels: bool = True):
    """Decode-step attention over int8 head-major caches -> f32 [B, H, Tq, dh]:
    kq/vq int8 [B, H, Tk, dh], ks/vs f32 [B, H, Tk], kv_lens [B]. Pads Tk
    to 128 if the caller did not (a no-op for caches from init_cache,
    whose padded scales are 0), the lengths then clamped to the unpadded
    Tk, and runs K9's int8 half (its plain version with kernels=False)."""
    Tk = kq.shape[2]
    if Tk % KERNEL_TK:
        kv_lens = torch.clamp(torch.as_tensor(kv_lens, device=qh.device), max=Tk)
        kq, vq, ks, vs = (pad_time_to_tk(a, 2) for a in (kq, vq, ks, vs))
    fn = grouped_decode_attention if kernels else decode_attention_plain
    return fn(qh, kq, vq, kv_lens, k_scale=ks, v_scale=vs)
