"""Where the time of Whisper large-v3 greedy serving goes on one GPU.

    python3 examples/torch_profile_whisper.py [--batch 16 --steps 8] [--int8]

Loads large-v3 at full width (random init, seed 0, on the card), encodes
B x 30 s of noise, builds the head-major caches (max_len 224), warms a few
decode steps, then runs under torch.profiler: (1) one encoder call, (2)
`--steps` decode steps. For each it prints the wall clock, the device busy
time and idle share, the number of device kernels launched, device
milliseconds by kernel name and the host self time of the busiest
operators; for the encoder call also its peak device memory (the weights
and inputs included). csrc/ln_gemm.cu's GEMM is named by its epilogue and
its entry point: ``gemm_kernel<0, 0>`` K5's q/k/v product,
``gemm_kernel<2, 0>`` K3c's fc1 + erf GELU, ``gemm_kernel<3, 0>`` K3c's
fc2 + residual, ``gemm_kernel<3, 1>`` K2h-out. `--int8` decodes with the int8 serving model
(``ModelBundle.quantize()``: K10 projections, int8 cross caches, int8 self
caches at batch >= 16, K11 logits). Needs a CUDA device.
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
from jiao_liao_speech_recognition_torch.decode import whisper_generate as wg  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch  # noqa: E402
from jiao_liao_speech_recognition_torch.utils.config import (  # noqa: E402
    ExperimentConfig,
    FrontendConfig,
    whisper_preset,
)


def report(name, prof, wall, per, top=18, **extra):
    rows, busy_us, launches = [], 0.0, 0
    host = []
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.device_time_total:
            busy_us += e.device_time_total
            launches += e.count
            rows.append((e.device_time_total, e.count, e.key))
        elif e.self_cpu_time_total:
            host.append((e.self_cpu_time_total, e.count, e.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    print(json.dumps({"section": name, "device": torch.cuda.get_device_name(0), "per": per,
                      "wall_s": wall, "device_busy_s": busy_us / 1e6,
                      "device_idle_share": 1.0 - busy_us / 1e6 / wall,
                      "device_kernels": launches, **extra}), flush=True)
    for us, count, key in rows[:top]:
        print(f"  device {us / 1e3:10.3f} ms  x{count:6d}  {key[:90]}")
    for us, count, key in host[:8]:
        print(f"  host   {us / 1e3:10.3f} ms  x{count:6d}  {key[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--int8", action="store_true", help="decode with bundle.quantize()")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    w = whisper_preset("large-v3")
    cfg = ExperimentConfig(model_family="whisper", whisper=w,
                           frontend=FrontendConfig(num_mels=w.num_mels))
    bundle = api.load(config=cfg, device="cuda")
    model = (bundle.quantize() if args.int8 else bundle).model
    prompt, eot = wg.resolve_specials(w)
    rng = np.random.RandomState(1)
    wav = torch.from_numpy((0.1 * rng.randn(args.batch, 30 * 16000)).astype(np.float32)).cuda()
    with torch.inference_mode():
        feats = featurize_batch(wav, cfg.frontend)
        enc = model.encode(feats)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.encode(feats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report("encoder", prof, wall, f"one call, B={args.batch} x 30 s",
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)

        caches = model.init_cache(args.batch, enc, 224)
        tok = torch.full((args.batch, 1), prompt[0], dtype=torch.long, device="cuda")
        pos = 0
        for _ in range(4):  # warm
            logits, caches = model.decode_step(tok, pos, enc, caches)
            tok = logits.argmax(-1, keepdim=True)
            pos += 1
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                logits, caches = model.decode_step(tok, pos, enc, caches)
                tok = logits.argmax(-1, keepdim=True)
                pos += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report("decode", prof, wall, f"{args.steps} steps at B={args.batch}, positions 4-{pos - 1}"
               + (", int8" if args.int8 else ""))


if __name__ == "__main__":
    main()
