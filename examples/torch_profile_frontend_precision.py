#!/usr/bin/env python3
"""A/B probe on one NVIDIA GPU: the log-mel kernel with its DFT as three bf16
tensor-core products (P1, bf16x3: hi.hi + lo.hi + hi.lo) against the full-f32
one (K1); the port's twin of examples/profile_frontend_precision.py.

    python3 examples/torch_profile_frontend_precision.py [--batch 128] [--secs 30] [--iters 8]

On the probe's seeded input (numpy RandomState(0), white noise at 0.1,
two distinct batches): device ms per batch of each kernel (torch.profiler,
--iters calls) and the largest difference between them on the raw log10-mel
and on the Whisper-normalized surface (clamp to the utterance max - 8,
then (x + 4) / 4), where K1's parity bar is 2e-4. Prints the report and a
JSON line; ``main(argv)`` returns the report. Needs a CUDA device: without
one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from jiao_liao_speech_recognition_torch.frontend.features import normalize_log_mel  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend.fused_frontend import fused_log_mel_raw  # noqa: E402
from jiao_liao_speech_recognition_torch.ops.probes import log_mel_bf16x3_raw  # noqa: E402
from jiao_liao_speech_recognition_torch.utils.config import FrontendConfig  # noqa: E402
from jiao_liao_speech_recognition_torch.utils.timing import cycling, device_ms  # noqa: E402

SAMPLE_RATE = 16000


def make_inputs(batch: int, secs: float, device: str = "cuda"):
    """The probe's two batches of white noise, f32 [batch, secs * 16 kHz]."""
    rng = np.random.RandomState(0)
    samples = int(secs * SAMPLE_RATE)
    return [torch.from_numpy(rng.randn(batch, samples).astype(np.float32) * 0.1).to(device)
            for _ in range(2)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--secs", type=float, default=30.0)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    wavs = make_inputs(args.batch, args.secs)
    fe = FrontendConfig()  # Whisper normalization, no CMVN
    with torch.inference_mode():
        t_f32 = device_ms(cycling(fused_log_mel_raw, wavs), args.iters)
        t_split = device_ms(cycling(log_mel_bf16x3_raw, wavs), args.iters)
        a, b = fused_log_mel_raw(wavs[0]), log_mel_bf16x3_raw(wavs[0])
        raw = float((a - b).abs().max())
        normalized = float((normalize_log_mel(a, fe) - normalize_log_mel(b, fe)).abs().max())
    report = {"device": torch.cuda.get_device_name(0), "batch": args.batch, "secs": args.secs,
              "k1_ms": t_f32, "p1_ms": t_split, "k1_over_p1": t_f32 / t_split,
              "max_abs_diff_raw": raw, "max_abs_diff_normalized": normalized}
    print(f"f32 kernel (K1)     : {t_f32:8.3f} ms/batch")
    print(f"bf16x3 kernel (P1)  : {t_split:8.3f} ms/batch  ({t_f32 / t_split:.2f}x)")
    print(f"max abs diff (raw log10-mel)       : {raw:.3e}")
    print(f"max abs diff (whisper-normalized)  : {normalized:.3e}")
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
