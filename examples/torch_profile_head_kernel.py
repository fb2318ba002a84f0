#!/usr/bin/env python3
"""A/B probe on one NVIDIA GPU: the head + argmax kernel that carries each
row's running (max, argmax) inside its block over 512-column vocabulary
chunks (P2, the TPU kernel's runtime chunk loop) against the shipped,
tile-parallel one that writes each 128-column tile's (max, first column)
and merges the tiles in a second launch (K4); the port's twin of
examples/profile_head_kernel.py. Both run the same TMA + wgmma mainloop
(csrc/head.cu), so the A/B asks one question: carry the argmax in 188
blocks of 128 rows, or merge per-tile partials of 6,392 blocks (at B=32).

    python3 examples/torch_profile_head_kernel.py [--batch 128] [--frames 750] [--vocab 4336]

On the probe's seeded input (numpy RandomState(0); d=512, bf16 weights,
two distinct batches of frames): the frames whose ids differ between K4
and P2 (none is expected: both form the same f32 logits) and each kernel's
device ms (torch.profiler). Prints the report and a JSON line;
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

from jiao_liao_speech_recognition_torch.ops.fused_head import fused_head_argmax  # noqa: E402
from jiao_liao_speech_recognition_torch.ops.probes import head_argmax_chunked  # noqa: E402
from jiao_liao_speech_recognition_torch.utils.timing import cycling, device_ms  # noqa: E402

D = 512


def make_inputs(batch: int, frames: int, vocab: int, device: str = "cuda"):
    """The probe's frames (two batches, bf16 [batch, frames, D]) and head:
    W [D, vocab] (bf16, as both kernels take it) and bias [vocab] f32."""
    rng = np.random.RandomState(0)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    x = f32(rng.randn(batch, frames, D).astype(np.float32) * 0.3).to(torch.bfloat16)
    w = f32(rng.randn(D, vocab).astype(np.float32) * 0.05).to(torch.bfloat16)
    bias = f32(rng.randn(vocab).astype(np.float32) * 0.01)
    x2 = f32(rng.randn(batch, frames, D).astype(np.float32) * 0.3).to(torch.bfloat16)
    return [x, x2], w, bias


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames", type=int, default=750)
    ap.add_argument("--vocab", type=int, default=4336)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    xs, w, bias = make_inputs(args.batch, args.frames, args.vocab)
    with torch.inference_mode():
        a, b = fused_head_argmax(xs[0], w, bias), head_argmax_chunked(xs[0], w, bias)
        mismatches = int((a != b).sum())
        t_k4 = device_ms(cycling(lambda x: fused_head_argmax(x, w, bias), xs))
        t_p2 = device_ms(cycling(lambda x: head_argmax_chunked(x, w, bias), xs))
    report = {"device": torch.cuda.get_device_name(0), "batch": args.batch,
              "frames": args.frames, "vocab": args.vocab, "id_mismatches": mismatches,
              "frames_compared": a.numel(), "k4_ms": t_k4, "p2_ms": t_p2}
    print(f"id mismatches K4 vs P2: {mismatches} / {a.numel()}")
    print(f"K4 (tile-parallel, merged)  : {t_k4:8.3f} ms/call")
    print(f"P2 (carried in the block)   : {t_p2:8.3f} ms/call  (P2 / K4 = {t_p2 / t_k4:.2f})")
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
