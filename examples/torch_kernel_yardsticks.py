#!/usr/bin/env python3
"""Library yardsticks for the port's kernels on one NVIDIA GPU.

    python3 examples/torch_kernel_yardsticks.py [--batch 16 --frames 750 --heads 8 --head-dim 64]

Times PyTorch's fused attention call (``F.scaled_dot_product_attention``
with a boolean key mask, on [B, H, T, dh] views of the port's [B, T, H, dh]
tensors), its forward alone and its backward alone, beside K6 (forward with
lse) and K8 (dQ, dK, dV) on the same bf16 inputs, and the forward without a
mask (``sdpa_unmasked_ms``: context where every key is valid), all by the
port's ``utils.timing.queued_ms`` (CUDA events with the calls queued behind
a spin kernel: events around a Python loop of 0.1-0.3 ms calls read the
host's dispatch). Then,
as context for the A/B probes at the flagship's 32 x 750 rows:
the library's two int8 products of P4's MLP (``torch._int_mm``) and the
head product + argmax of K4 and P2 (``torch.addmm`` then ``torch.argmax``),
device time. Each of those is two calls, not one call of the kernel's
function: the int8 pair is context, and ``chip_smoke.py`` takes the head's
pair (``addmm_argmax``, timed as K4 is) as K4's ``library_ms``, marked as
two calls. ``sdpa_forward_ms`` is
the masked forward alone, context beside K2's attention core.
``qkv_products_ms`` and ``mlp_products_ms`` time cuBLAS's products alone
(``torch.addmm``) on a
precomputed LN(x), the context ``chip_smoke.py`` prints beside K5 and K3c,
whose function no one library call computes. The port never calls a
library kernel: ``chip_smoke.py`` reads ``sdpa_ms`` for the ``library_ms``
of K6 and K8, ``addmm_argmax`` for K4's, and prints the probe context.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds per call (CUDA events), after a warm call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sdpa_forward_ms(q, k, v, kv_lengths, iters: int = 20) -> float:
    """-> ms of the library's forward alone on q, k, v [B, T, H, dh] bf16
    (any strides) with keys at or past kv_lengths[b] masked out
    (queued_ms): context beside K2's attention core, whose rounding point
    differs (it normalises P before P.V)."""
    from jiao_liao_speech_recognition_torch.utils.timing import queued_ms

    Tk = k.shape[1]
    mask = (torch.arange(Tk, device=k.device)[None, :] < kv_lengths[:, None].long())
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    with torch.no_grad():
        return queued_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask[:, None, None, :]), iters)


def sdpa_ms(q, k, v, kv_lengths, dout, iters: int = 20):
    """-> (forward ms, backward ms) of the library call on q, k, v, dout
    [B, T, H, dh] bf16 with keys at or past kv_lengths[b] masked out
    (queued_ms)."""
    from jiao_liao_speech_recognition_torch.utils.timing import queued_ms

    B, Tk = k.shape[0], k.shape[1]
    mask = (torch.arange(Tk, device=k.device)[None, :] < kv_lengths[:, None].long())
    mask = mask[:, None, None, :]  # [B, 1, 1, Tk]: one key mask per row
    qh, kh, vh = (t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v))
    doh = dout.transpose(1, 2)

    def forward():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    with torch.no_grad():
        fwd = queued_ms(forward, iters)
    with torch.enable_grad():
        out = forward()
        bwd = queued_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True),
                        iters)
    return fwd, bwd


def sdpa_unmasked_ms(q, k, v, iters: int = 20) -> float:
    """-> ms of the library's forward on q, k, v [B, T, H, dh] bf16 with no
    mask at all (queued_ms): its fastest form, and the same function as K6's
    only where every key is valid. Context beside ``sdpa_ms``, not a
    library_ms."""
    from jiao_liao_speech_recognition_torch.utils.timing import queued_ms

    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    with torch.no_grad():
        return queued_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters)


def sdpa_decode(qh, k, v, kv_lengths):
    """-> a call of the library at decode shapes: qh [B, H, Tq, dh] against
    head-major k, v [B, H, Tk, dh] (K9's layout), keys at or past
    kv_lengths[b] masked out by a boolean key mask."""
    Tk = k.shape[2]
    mask = (torch.arange(Tk, device=k.device)[None, :] < kv_lengths[:, None].long())
    mask = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def int_mm_pair_ms(a_codes, w1q, h_codes, w2q, iters: int = 20) -> float:
    """-> device ms of the library's two int8 products of P4's MLP
    (``torch._int_mm``, int32 out): LN codes [M, d] by w1q [d, mlp] and
    hidden codes [M, mlp] by w2q [mlp, d]. Context for P4, not its function:
    two calls, without LayerNorm, scales, GELU or residual."""
    from jiao_liao_speech_recognition_torch.utils.timing import device_ms

    return device_ms(lambda: (torch._int_mm(a_codes, w1q), torch._int_mm(h_codes, w2q)), iters)


def addmm_argmax(x2, w, bias):
    """cuBLAS's head product with its bias (``torch.addmm``, the bf16 [rows,
    V] logits written out) and ``torch.argmax`` over them: the function of
    K4 and P2 in two library calls (x2 [rows, d], w [d, V], bias [V], bf16)."""
    return torch.argmax(torch.addmm(bias, x2, w), dim=-1)


def addmm_argmax_ms(x2, w, bias, iters: int = 20) -> float:
    """-> device ms of ``addmm_argmax``."""
    from jiao_liao_speech_recognition_torch.utils.timing import device_ms

    return device_ms(lambda: addmm_argmax(x2, w, bias), iters)


def qkv_products_ms(ln2, w_qkv, b_qkv, iters: int = 20) -> float:
    """-> ms of cuBLAS's q/k/v product with its bias (one ``torch.addmm``)
    on a precomputed bf16 LN(x) [M, d]: K5's products alone, without its
    LayerNorm pass or its rounding before the bias. Context, not K5's
    function."""
    return cuda_ms(lambda: torch.addmm(b_qkv, ln2, w_qkv), iters)


def mlp_products_ms(ln2, w1, b1, w2, b2, h2, iters: int = 20) -> dict:
    """-> {"fc1_ms", "fc2_ms", "ms"}: cuBLAS's two MLP products with their
    biases (``torch.addmm``), timed apart and summed, on a precomputed bf16
    LN(x) [M, d] and hidden tensor h2 [M, mlp]: K3's products alone,
    without LayerNorm, GELU, residual or its roundings. Context, not K3's
    function."""
    fc1 = cuda_ms(lambda: torch.addmm(b1, ln2, w1), iters)
    fc2 = cuda_ms(lambda: torch.addmm(b2, h2, w2), iters)
    return {"fc1_ms": fc1, "fc2_ms": fc2, "ms": fc1 + fc2}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=750)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--head-dim", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from jiao_liao_speech_recognition_torch.ops import flash_attention as fl
    from jiao_liao_speech_recognition_torch.utils.timing import queued_ms

    B, T, H, dh = args.batch, args.frames, args.heads, args.head_dim
    rng = np.random.RandomState(0)
    q, k, v, dout = (torch.from_numpy(rng.randn(B, T, H, dh).astype(np.float32))
                     .cuda().to(torch.bfloat16) for _ in range(4))
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    out, lse = fl.flash_forward(q, k, v, lens)
    k6 = queued_ms(lambda: fl.flash_forward(q, k, v, lens))
    k8 = queued_ms(lambda: fl.flash_backward(q, k, v, lens, out, lse, dout))
    lib_fwd, lib_bwd = sdpa_ms(q, k, v, lens, dout)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "B": B, "T": T, "heads": H,
                      "dh": dh, "k6_ms": k6, "k8_ms": k8, "sdpa_forward_ms": lib_fwd,
                      "sdpa_backward_ms": lib_bwd,
                      "sdpa_unmasked_forward_ms": sdpa_unmasked_ms(q, k, v)}))
    M, d, mlp, V = 32 * 750, 512, 2048, 4336
    codes = [torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda")
             for shape in ((M, d), (d, mlp), (M, mlp), (mlp, d))]
    x2 = torch.randn(M, d, device="cuda").to(torch.bfloat16)
    w = (0.05 * torch.randn(d, V, device="cuda")).to(torch.bfloat16)
    bias = (0.01 * torch.randn(V, device="cuda")).to(torch.bfloat16)
    print(json.dumps({"context": "two library calls each, not one call of the kernel's function",
                      "rows": M, "p4_int_mm_pair_ms": int_mm_pair_ms(*codes),
                      "k4_p2_addmm_argmax_ms": addmm_argmax_ms(x2, w, bias)}))


if __name__ == "__main__":
    main()
