#!/usr/bin/env python3
"""A/B probe on one NVIDIA GPU: the W8A8 LN + MLP + residual kernel (P4, int8
tensor cores) against the bf16 one (K3); the port's twin of
examples/profile_w8a8_mlp.py.

    python3 examples/torch_profile_w8a8_mlp.py [--b 128] [--t 1500]

At the flagship's MLP shape (d=512, mlp=2048, tanh GELU) with the probe's
seeded weights and inputs (numpy RandomState(0), drawn in its order; int8
weights per output channel by ops.quant.quantize_int8): max |w8a8 - bf16|
and its value relative to max |bf16|, then each sublayer's device ms
(torch.profiler, over two distinct warmed inputs), its rate in T(FL)OPS
and its launches apart (device us a call by kernel name: P4's LN + codes,
fc1 for the hidden amax, fc1 for the hidden codes, fc2 + residual; K3's
LN, fc1 + GELU, fc2 + residual). Prints the report and a JSON line;
``main(argv)`` returns the report. Needs a CUDA device: without one it
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from jiao_liao_speech_recognition_torch.ops import fused_mlp, probes  # noqa: E402
from jiao_liao_speech_recognition_torch.ops.quant import quantize_int8  # noqa: E402
from jiao_liao_speech_recognition_torch.utils.timing import cycling, device_ms  # noqa: E402

D, MLP, GELU_FORM, EPS = 512, 2048, "tanh", 1e-5


def make_inputs(B: int, T: int, device: str = "cuda"):
    """The probe's parameters (f32) and two bf16 inputs [B, T, D]."""
    rng = np.random.RandomState(0)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    p = {"g": f32(rng.randn(D).astype(np.float32) * 0.1 + 1.0),
         "bl": f32(rng.randn(D).astype(np.float32) * 0.05),
         "w1": f32(rng.randn(D, MLP).astype(np.float32) * (1 / np.sqrt(D))),
         "b1": f32(rng.randn(MLP).astype(np.float32) * 0.02),
         "w2": f32(rng.randn(MLP, D).astype(np.float32) * (1 / np.sqrt(MLP))),
         "b2": f32(rng.randn(D).astype(np.float32) * 0.02)}
    xs = [f32(rng.randn(B, T, D).astype(np.float32) * 0.5).to(torch.bfloat16) for _ in range(2)]
    return p, xs


def sublayers(p):
    """-> (bf16 K3 call, W8A8 P4 call) of x, each on the weights it takes
    (P4's laid out once by probes.w8a8_operands)."""
    bf = torch.bfloat16
    w1b, b1b, w2b, b2b = (p[k].to(bf) for k in ("w1", "b1", "w2", "b2"))
    (w1q, s1), (w2q, s2) = quantize_int8(p["w1"]), quantize_int8(p["w2"])
    ops = probes.w8a8_operands(w1q, s1, p["b1"], w2q, s2, p["b2"])

    def bf16(x):
        return fused_mlp.fused_ln_mlp_residual(x, p["g"], p["bl"], w1b, b1b, w2b, b2b, EPS,
                                               GELU_FORM)

    def w8a8(x, kernels=True, scratch=None):
        return probes.w8a8_ln_mlp_residual(x, p["g"], p["bl"], ops, EPS, GELU_FORM,
                                           kernels=kernels, scratch=scratch)

    return bf16, w8a8


def launch_us(fn, xs, calls: int = 10) -> dict:
    """-> {kernel name: device us a call} over ``calls`` calls of fn,
    cycling through xs, after three warm ones."""
    from torch.profiler import ProfilerActivity, profile

    for i in range(3):
        fn(xs[i % len(xs)])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(xs[i % len(xs)])
        torch.cuda.synchronize()
    return {e.key.replace("void (anonymous namespace)::", "").split("(")[0]:
            e.device_time_total / calls for e in prof.key_averages() if e.device_time_total}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--t", type=int, default=1500)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    B, T = args.b, args.t
    p, xs = make_inputs(B, T)
    bf16, w8a8 = sublayers(p)
    ops = 4 * B * T * D * MLP
    with torch.inference_mode():
        ya, yb = bf16(xs[0]).float(), w8a8(xs[0]).float()
        err = float((ya - yb).abs().max())
        rel = err / float(ya.abs().max())
        report = {"device": torch.cuda.get_device_name(0), "B": B, "T": T, "d": D, "mlp": MLP,
                  "max_abs_diff": err, "rel_diff": rel}
        print(f"max |w8a8 - bf16| = {err:.4f}  (rel {rel:.4f})", flush=True)
        for key, name, fn in (("k3", "bf16 fused (K3)", bf16), ("p4", "w8a8 fused (P4)", w8a8)):
            ms = device_ms(cycling(fn, xs))
            report[f"{key}_ms"], report[f"{key}_tops"] = ms, ops / ms / 1e9
            print(f"{name}: {ms:8.3f} ms/sublayer  {ops / ms / 1e9:7.1f} T(FL)OPS", flush=True)
            report[f"{key}_launch_us"] = launch_us(fn, xs)
            for kernel, us in report[f"{key}_launch_us"].items():
                print(f"    {us:9.1f} us  {kernel}", flush=True)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
