"""The A/B probes of ``examples/``: three kernels that the JAX package keeps
beside a production kernel to measure an alternative to it, ported with
their plain versions.

* P4, ``w8a8_ln_mlp_residual``: K3's function with int8 products (W8A8),
  the kernel of ``examples/profile_w8a8_mlp.py``; ``csrc/w8a8_mlp.cu``, on
  the weights as ``w8a8_operands`` lays them out once.
* P1, ``log_mel_bf16x3_raw``: K1's log-mel with the DFT as three bf16
  products, the kernel of ``examples/profile_frontend_precision.py``;
  ``jl_log_mel_bf16x3``, the bf16 instance of K1's kernel in
  ``csrc/log_mel_tf32.cu``.
* P2, ``head_argmax_chunked``: K4's head + argmax with the running (max,
  argmax) carried in the block over 512-column vocabulary chunks, the
  kernel of ``examples/profile_head_kernel.py``; ``jl_head_argmax_chunked``
  of ``csrc/head.cu``, on K4's mainloop (K4 merges per-tile partials).

They are measurement tools: no model, bundle or api function calls this
module. The port's profilers (``examples/torch_profile_w8a8_mlp.py``,
``torch_profile_frontend_precision.py``, ``torch_profile_head_kernel.py``)
run each beside its partner, and chip_smoke.py holds each against its
plain version. A wrapper takes the plain version for a CPU tensor (or with
``kernels=False``); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .._build import LaunchCounter, check_aligned, check_cuda, launch, refuse_grad
from ..frontend.features import _dft_basis, mel_filterbank
from ..frontend.fused_frontend import (BASIS_K, BASIS_N, K_STEP, MAX_HOP, bf16_split,
                                       mel_bands, tf32_basis)
from .fused_head import head_argmax_plain, head_operands
from .fused_mlp import gelu_f32
from .numerics import full_f32

W8A8_COUNTER = LaunchCounter("w8a8_ln_mlp_residual")  # P4
BF16X3_COUNTER = LaunchCounter("log_mel_bf16x3_raw")  # P1
CHUNKED_COUNTER = LaunchCounter("head_argmax_chunked")  # P2
INV_LN10 = float(np.float32(1.0 / np.log(10.0)))


# --- P4: W8A8 LN + MLP + residual -----------------------------------------------


def _quantize_rows(a: torch.Tensor):
    """Per-row dynamic int8 of f32 a [.., n] -> (codes as f32, scale [.., 1]):
    scale = amax / 127, codes = clip(round(a / safe), +-127), round half to
    even, safe = 1 where the scale is 0."""
    scale = a.abs().amax(-1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(a / safe), -127, 127), scale


def _int_product(codes: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The int32 product of int8 codes, rounded to f32 as acc.astype(f32):
    float64 holds every partial sum exactly (|sum| <= 127^2 K < 2^53), on
    the CPU and on the card alike."""
    return (codes.double() @ wq.double()).float()


def w8a8_ln_mlp_residual_plain(x, g, bl, w1q, s1, b1, w2q, s2, b2, eps=1e-5, gelu_form="tanh"):
    """The probe's numerics: x [.., d] bf16; w1q int8 [d, mlp], w2q int8
    [mlp, d] with per-output-channel f32 scales s1, s2 (ops.quant's
    quantize_int8); f32 LN, per-row int8 codes before each product,
    h = acc * (a_s * s1) + b1, GELU in f32, y = acc2 * (h_s * s2) + b2,
    out = x + bf16(y)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    ln = (xc * torch.rsqrt(var + eps)) * g.float() + bl.float()
    lq, a_s = _quantize_rows(ln)
    h = _int_product(lq, w1q) * (a_s * s1.float()) + b1.float()
    hq, h_s = _quantize_rows(gelu_f32(h, gelu_form))
    y = _int_product(hq, w2q) * (h_s * s2.float()) + b2.float()
    return x + y.to(x.dtype)


class W8A8Operands(NamedTuple):
    """P4's weights as its kernel reads them: each product's int8 codes
    K-major ([out][in], the only layout the 8-bit wgmma takes), the
    per-output-channel scales and the biases in f32."""

    w1t: torch.Tensor  # int8 [mlp, d]: fc1's codes, transposed
    s1: torch.Tensor   # f32 [mlp]
    b1: torch.Tensor   # f32 [mlp]
    w2t: torch.Tensor  # int8 [d, mlp]: fc2's codes, transposed
    s2: torch.Tensor   # f32 [d]
    b2: torch.Tensor   # f32 [d]


def w8a8_operands(w1q, s1, b1, w2q, s2, b2, device=None) -> W8A8Operands:
    """-> W8A8Operands from int8 w1q [d, mlp], w2q [mlp, d] (ops.quant's
    quantize_int8 of the [in, out] kernels) and their scales and biases,
    on ``device`` (default: w1q's). Made once, not on each call."""
    device = w1q.device if device is None else device
    return W8A8Operands(
        w1q.t().to(device).contiguous(), s1.to(device, torch.float32).contiguous(),
        b1.to(device, torch.float32).contiguous(), w2q.t().to(device).contiguous(),
        s2.to(device, torch.float32).contiguous(), b2.to(device, torch.float32).contiguous())


def w8a8_ln_mlp_residual(x, g, bl, ops: W8A8Operands, eps=1e-5, gelu_form="tanh",
                         kernels=True, scratch=None):
    """P4 wrapper. CPU tensors (or kernels=False) take the plain version on
    the operands' codes; a CUDA tensor launches the kernel (x bf16 [B, T,
    d], d and mlp multiples of 128, d <= 2048: four launches,
    csrc/w8a8_mlp.cu) or raises. The launches pass their intermediates
    through scratch this allocates; a dict given as ``scratch`` receives
    them: "ln_codes" [B*T, d] int8, "ln_scale" [B*T] f32, "hidden_amax"
    [B*T] f32 and "hidden_codes" [B*T, mlp] int8."""
    if x.device.type == "cpu" or not kernels:
        return w8a8_ln_mlp_residual_plain(x, g, bl, ops.w1t.t(), ops.s1, ops.b1, ops.w2t.t(),
                                          ops.s2, ops.b2, eps, gelu_form)
    check_cuda("x", x, torch.bfloat16, 3)
    check_cuda("w1t", ops.w1t, torch.int8, 2)
    check_cuda("w2t", ops.w2t, torch.int8, 2)
    refuse_grad("w8a8_ln_mlp_residual", x, g, bl, *ops)
    B, T, d = x.shape
    mlp = ops.w1t.shape[0]
    widths = {"s1": mlp, "b1": mlp, "s2": d, "b2": d}
    if (B * T == 0 or d % 128 or mlp % 128 or d > 2048 or tuple(ops.w1t.shape) != (mlp, d)
            or tuple(ops.w2t.shape) != (d, mlp)
            or any(tuple(getattr(ops, k).shape) != (n,) for k, n in widths.items())):
        raise ValueError(f"unsupported W8A8 MLP shape d={d} mlp={mlp}")
    if gelu_form not in ("tanh", "erf"):
        raise ValueError(f"unknown gelu_form {gelu_form!r} (want 'tanh'|'erf')")
    g, bl = (v.to(x.device, torch.float32).contiguous() for v in (g, bl))
    M, dev = B * T, x.device
    lq = torch.empty(M, d, device=dev, dtype=torch.int8)
    a_s, amax = (torch.empty(M, device=dev, dtype=torch.float32) for _ in range(2))
    hq = torch.empty(M, mlp, device=dev, dtype=torch.int8)
    out = torch.empty_like(x)
    check_aligned("w8a8_ln_mlp_residual", x, *ops, g, bl)
    launch(
        "jl_w8a8_ln_mlp_residual", x.data_ptr(), g.data_ptr(), bl.data_ptr(),
        ops.w1t.data_ptr(), ops.s1.data_ptr(), ops.b1.data_ptr(), ops.w2t.data_ptr(),
        ops.s2.data_ptr(), ops.b2.data_ptr(), lq.data_ptr(), a_s.data_ptr(), amax.data_ptr(),
        hq.data_ptr(), out.data_ptr(), M, d, mlp, int(gelu_form == "erf"), float(eps),
    )
    W8A8_COUNTER.launches += 1
    if scratch is not None:
        scratch.update(ln_codes=lq, ln_scale=a_s, hidden_amax=amax, hidden_codes=hq)
    return out


# --- P1: log-mel with a bf16x3 DFT ----------------------------------------------


def _split_bf16(a: torch.Tensor):
    """f32 a -> (hi, lo) as f32 tensors of bf16 values: hi = bf16(a),
    lo = bf16(a - hi)."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def log_mel_bf16x3_plain(wav, n_fft=400, hop=160, num_mels=80, log_floor=1e-10):
    """K1's framing (reflect pad, hop frames, the final frame dropped) with
    the probe's DFT: frames and windowed basis split into bf16 hi and lo,
    proj = hi.hi + lo.hi + hi.lo as f32 products of the bf16 values (each
    exact, no TF32), power, the f32 mel product, log(max(., floor)) *
    f32(1/ln 10) -> [B, num_mels, L // hop]."""
    pad = n_fft // 2
    x = F.pad(wav.to(torch.float32)[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)[:, :-1]  # [B, L//hop, n_fft]
    basis = torch.from_numpy(_dft_basis(n_fft).T.copy()).to(wav.device)  # [n_fft, 2F]
    mel = torch.from_numpy(mel_filterbank(num_mels, n_fft)).to(wav.device)
    n_freqs = n_fft // 2 + 1
    f_hi, f_lo = _split_bf16(frames)
    b_hi, b_lo = _split_bf16(basis)
    with full_f32():
        proj = f_hi @ b_hi + f_lo @ b_hi + f_hi @ b_lo
        power = proj[..., :n_freqs] ** 2 + proj[..., n_freqs:] ** 2
        mel_spec = power @ mel.T
    return (torch.log(torch.clamp(mel_spec, min=log_floor)) * INV_LN10).transpose(1, 2)


def kernel_basis(n_fft: int, rows: int, f_pad: int) -> np.ndarray:
    """The windowed DFT basis in P1's layout, f32 [rows, 2 f_pad]: columns
    [0, n_freqs) window * cos, [f_pad, f_pad + n_freqs) -window * sin, zero
    elsewhere and past n_fft rows."""
    n_freqs = n_fft // 2 + 1
    b = _dft_basis(n_fft)
    basis = np.zeros((rows, 2 * f_pad), np.float32)
    basis[:n_fft, :n_freqs] = b[:n_freqs].T
    basis[:n_fft, f_pad : f_pad + n_freqs] = b[n_freqs:].T
    return basis


@lru_cache(maxsize=8)
def _bf16x3_constants(n_fft: int, num_mels: int, device: str):
    """The basis in the plain version's [k, cos | -sin] layout (n_fft and
    n_freqs rounded up to 16, zero-padded) split into bf16 hi and lo, and
    mel [num_mels, n_freqs] f32: the values the kernel's interleaved copy
    (_bf16x3_kernel_constants) must carry, which the tests hold it to."""
    n_k, f16 = -(-n_fft // 16) * 16, -(-(n_fft // 2 + 1) // 16) * 16
    full = torch.from_numpy(kernel_basis(n_fft, n_k, f16)).to(device)
    hi = full.to(torch.bfloat16)
    lo = (full - hi.float()).to(torch.bfloat16)
    mel = torch.from_numpy(np.ascontiguousarray(mel_filterbank(num_mels, n_fft))).to(device)
    return hi, lo, mel


@lru_cache(maxsize=8)
def _bf16x3_kernel_constants(n_fft: int, num_mels: int, device: str):
    """P1's operands in K1's layout: K1's basis [BASIS_N, BASIS_K]
    (fused_frontend.tf32_basis) split into bf16 hi and lo by bf16_split,
    mel [num_mels, n_freqs] f32 and its bands [num_mels, 2] i32."""
    mel = np.ascontiguousarray(mel_filterbank(num_mels, n_fft))
    hi, lo = bf16_split(tf32_basis(n_fft))
    return (hi.to(device), lo.to(device), torch.from_numpy(mel).to(device),
            torch.from_numpy(mel_bands(mel)).to(device))


def log_mel_bf16x3_raw(wav, n_fft=400, hop=160, num_mels=80, log_floor=1e-10, kernels=True):
    """P1 wrapper. CPU tensors (or kernels=False) take log_mel_bf16x3_plain;
    a CUDA tensor launches the kernel (wav f32 [B, L], L > n_fft // 2; K1's
    limits: hop % 16 == 0, hop <= MAX_HOP, n_fft <= BASIS_K and
    n_fft // 2 + 1 <= BASIS_N / 2) or raises."""
    if wav.device.type == "cpu" or not kernels:
        return log_mel_bf16x3_plain(wav, n_fft, hop, num_mels, log_floor)
    check_cuda("wav", wav, torch.float32, 2)
    B, L = wav.shape
    n_freqs = n_fft // 2 + 1
    if (L <= n_fft // 2 or hop % K_STEP or hop > MAX_HOP or n_fft > BASIS_K
            or 2 * n_freqs > BASIS_N):
        raise ValueError(f"unsupported bf16x3 log-mel: L={L} n_fft={n_fft} hop={hop}")
    T = L // hop
    hi, lo, mel, bands = _bf16x3_kernel_constants(n_fft, num_mels, str(wav.device))
    out = torch.empty(B, num_mels, T, device=wav.device, dtype=torch.float32)
    launch(
        "jl_log_mel_bf16x3", wav.data_ptr(), hi.data_ptr(), lo.data_ptr(), mel.data_ptr(),
        bands.data_ptr(), out.data_ptr(), B, L, T, n_fft, hop, n_freqs, num_mels,
        float(log_floor),
    )
    BF16X3_COUNTER.launches += 1
    return out


# --- P2: head + argmax, the argmax carried over 512-column chunks ----------------


def head_argmax_chunked(x, kernel, bias, kernels=True):
    """P2 wrapper -> int32 ids [B, T]. P2 computes K4's function, so its
    plain version is K4's ``head_argmax_plain`` (ops/fused_head.py), which
    CPU tensors (or kernels=False) take; a CUDA tensor launches the kernel
    (one launch; the operands as K4's ``head_operands`` takes them) or
    raises."""
    if x.device.type == "cpu" or not kernels:
        return head_argmax_plain(x, kernel, bias)
    w, b = head_operands("jl_head_argmax_chunked", x, kernel, bias)
    B, T, d = x.shape
    ids = torch.empty(B, T, device=x.device, dtype=torch.int32)
    launch("jl_head_argmax_chunked", x.data_ptr(), w.data_ptr(), b.data_ptr(), ids.data_ptr(),
           B * T, d, b.shape[0], w.shape[1])
    CHUNKED_COUNTER.launches += 1
    return ids
