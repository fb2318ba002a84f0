"""Device-time breakdown of the PyTorch port's greedy path on one GPU.

    python3 examples/torch_profile_greedy.py [--batch 32]

Runs the kernel path (K1 log-mel -> encoder with K2/K3 per block -> K4 head
+ argmax -> collapse) of the full-width flagship (random init, seed 0) on
B x 30 s of noise under torch.profiler, after warming two distinct input
buffers. Prints the wall clock, the device busy time and idle share, and
device milliseconds per batch by kernel name (the 25 largest, then every
other launch of the port's kernels), each of the port's kernels labelled
with the launch it is (K2's four, K3's three, K1, K4's two). The labels
come from the kernels' names and template tags (csrc/ln_gemm.cu's
``gemm_kernel<EPILOGUE, ENTRY>`` and ``ln_rows_kernel<ENTRY>``): profiler
ranges around launches would be counted as device time too. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from jiao_liao_speech_recognition_torch import api  # noqa: E402
from jiao_liao_speech_recognition_torch.decode.ctc import ctc_greedy_collapse  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch  # noqa: E402


# kernel name (its start) -> the launch it is
LAUNCHES = {
    "log_mel_tf32_kernel": "K1",
    "ln_rows_kernel<0>": "K2 1/4 ln_rows",
    "gemm_kernel<0, 0>": "K2 2/4 q/k/v GEMM + bias",
    "attention_core_kernel<": "K2 3/4 attention core",
    "gemm_kernel<4, 2>": "K2 4/4 out-projection + x + bias",
    "ln_rows_kernel<1>": "K3 1/3 ln_rows",
    "gemm_kernel<1, 0>": "K3 2/3 fc1 + tanh GELU",
    "gemm_kernel<2, 0>": "K3 2/3 fc1 + erf GELU",
    "gemm_kernel<3, 0>": "K3 3/3 fc2 + bias + x",
    "head_tile_argmax_kernel": "K4 1/2 head GEMM + argmax epilogue",
    "head_merge_kernel": "K4 2/2 merge of the tiles",
}


def launch_label(name: str) -> str:
    """The port's launch a profiler kernel name is, or "" (PyTorch's own)."""
    bare = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
    return next((label for key, label in LAUNCHES.items() if bare.startswith(key)), "")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    bundle = api.load(device="cuda")
    fe = bundle.config.frontend
    samples = int(fe.chunk_seconds * fe.sample_rate)
    rng = np.random.RandomState(1)
    bufs = [
        torch.from_numpy((0.1 * rng.randn(args.batch, samples)).astype(np.float32)).cuda()
        for _ in range(2)
    ]
    flens = torch.full((args.batch,), samples // fe.hop_length, dtype=torch.int32, device="cuda")

    @torch.inference_mode()
    def infer(wav):
        feats = featurize_batch(wav, fe)
        ids, olens = bundle.model(feats, flens, head_mode="argmax_ids")
        return ctc_greedy_collapse(ids, olens)

    for w in bufs:
        infer(w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.iters):
            infer(bufs[i % 2])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    rows, busy_us = [], 0.0
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.device_time_total:
            busy_us += e.device_time_total
            rows.append((e.device_time_total, e.count, e.key))
    rows.sort(reverse=True)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "batch": args.batch, "iters": args.iters,
        "wall_s": wall, "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
    }))
    # the 25 largest rows, then any of the port's launches below them
    shown = rows[:25] + [r for r in rows[25:] if launch_label(r[2])]
    for us, count, key in shown:
        print(f"{us / 1e3 / args.iters:9.3f} ms/batch  x{count // args.iters:4d}  "
              f"{launch_label(key):34s} {key[:70]}")


if __name__ == "__main__":
    main()
