#!/usr/bin/env python3
"""Device-time breakdown of one adapter fine-tune step of the PyTorch port.

    python3 examples/torch_profile_train.py [--batch 16] [--seconds 30] [--graph | --no-graph] [--plain]

Builds the model of ``configs/adapter_finetune.yaml`` at full width (12 x
d512, 8 heads of 64, mlp 2048, WF rank 8 on every projection, dropout 0.1,
SpecAugment on; random init from seed 0, backbone frozen), takes a step on
each of two distinct synthetic batches (noise, 128 random labels each) of
one bucket, then profiles ``--iters`` train steps with torch.profiler. The
step is the train loop's (``train/engine.TrainStep``): ``--graph`` (the
default) replays the bucket's captured CUDA graph, ``--no-graph`` runs the
same step eagerly. Prints the wall clock, the device busy time and idle
share, and device milliseconds per step by kernel name. Busy time is
chip_smoke.py's ``device_profile`` definition: the device time of every
CUDA event except user-annotated ranges (such as the optimizer's step),
whose time is that of the kernels inside them, already counted. ``--plain``
runs the plain versions instead of the kernels (K1; K6 and K8 at T' >=
512; the CTC loss), eagerly. Needs a CUDA device.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from jiao_liao_speech_recognition_torch.models.ctc_model import CTCEncoderModel  # noqa: E402
from jiao_liao_speech_recognition_torch.train import engine  # noqa: E402
from jiao_liao_speech_recognition_torch.utils.config import load_yaml  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--graph", action=argparse.BooleanOptionalAction, default=True,
                    help="replay the step's captured CUDA graph (default), or run it eagerly")
    ap.add_argument("--plain", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = not args.plain
    graph = args.graph and kernels

    cfg = load_yaml(str(ROOT / "configs" / "adapter_finetune.yaml"))
    model = CTCEncoderModel(cfg.ctc_model, device="cuda", seed=cfg.train.seed)
    step = engine.TrainStep(cfg, engine.init_state(cfg, model), kernels, graph=graph)
    B, samples = args.batch, int(args.seconds * cfg.frontend.sample_rate)
    rng = np.random.RandomState(0)
    batches = [{
        "audio": torch.from_numpy((0.1 * rng.randn(B, samples)).astype(np.float32)),
        "audio_lengths": torch.full((B,), samples, dtype=torch.int32),
        "labels": torch.from_numpy(
            rng.randint(1, cfg.ctc_model.vocab_size, (B, 128)).astype(np.int32)),
        "label_lengths": torch.full((B,), 128, dtype=torch.int32),
    } for _ in range(2)]
    for b in batches:  # the first warms (and, with --graph, captures)
        step(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.iters):
            metrics = step(batches[i % 2])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    rows, busy_us = [], 0.0
    for e in prof.key_averages():
        if (e.device_type.name == "CUDA" and e.device_time_total
                and not getattr(e, "is_user_annotation", False)):
            busy_us += e.device_time_total
            rows.append((e.device_time_total, e.count, e.key))
    rows.sort(reverse=True)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "batch": B, "seconds": args.seconds,
        "kernels": kernels, "graph": graph, "iters": args.iters,
        "loss": float(metrics["loss"]), "capture_s": step.capture_s,
        "wall_s_per_step": wall / args.iters, "device_busy_s_per_step": busy_us / 1e6 / args.iters,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "launches_per_step": sum(r[1] for r in rows) / args.iters,
    }))
    for us, count, key in rows[:30]:
        print(f"{us / 1e3 / args.iters:9.3f} ms/step  x{count // args.iters:4d}  {key[:90]}")
    print("host: self CPU time per step by operator")
    cpu = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in cpu[:25]:
        print(f"{e.self_cpu_time_total / 1e3 / args.iters:9.3f} ms/step  "
              f"x{e.count // args.iters:5d}  {e.key[:90]}")


if __name__ == "__main__":
    main()
