#!/usr/bin/env python3
"""What holds K1 (csrc/log_mel_tf32.cu) on one NVIDIA GPU.

    python3 examples/torch_profile_log_mel.py [--batch 32] [--secs 30] [--iters 20]

Builds K1 three ways from edited copies of ``csrc/`` (under a temporary
directory, each its own library): as it is; its TMA feed alone (the
consumers wait for each basis stage and release it, with no products: the
fragments and adds stay); and its products alone (no basis copies and no
waits for them, the same wgmma and adds on whatever the stages hold).
Times each on B x secs of seeded noise (CUDA events, --iters calls, two
rounds in turns) and prints a JSON line with the card's name. The staging
of the signal, the power and the mel product run in all three. Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from jiao_liao_speech_recognition_torch import _build  # noqa: E402
from jiao_liao_speech_recognition_torch.frontend import fused_frontend  # noqa: E402


def _without(text: str, lines) -> str:
    """text with each of `lines` taken out; each must be there."""
    for line in lines:
        if line not in text:
            raise SystemExit(f"csrc/log_mel_tf32.cu changed: {line.strip()!r} not found")
        text = text.replace(line, "")
    return text


def variants(src: str) -> dict:
    """K1's source as it is, with its TMA feed alone (no products), with its
    products alone (no basis copies, no waits for them)."""
    feed = _without(src, (
        "          mma_tf32_n104(part, alo[kk], basis_desc(bh, kk), kk);\n",
        "          mma_tf32_n104(part, ahi[kk], basis_desc(bl, kk), 1);\n",
        "          mma_tf32_n104(part, ahi[kk], basis_desc(bh, kk), 1);\n"))
    math = _without(src, (
        "      mbar_wait_untimed(&full[s], (i / kStages) & 1);\n",
        "        mbar_arrive_expect_tx(&full[s], kStageBytes);\n",
        "        tma_load_2d(dst, &thi, ks * kKStep, pass * kPassN, &full[s]);\n",
        "        tma_load_2d(dst + kBoxBytes, &tlo, ks * kKStep, pass * kPassN, &full[s]);\n",
        "        if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);\n"))
    return {"as_is": src, "tma_feed_only": feed, "products_only": math}


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--secs", type=float, default=30.0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    rng = np.random.RandomState(1)
    wav = torch.from_numpy(
        (0.1 * rng.randn(args.batch, int(args.secs * 16000))).astype(np.float32)).cuda()
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    times = {}
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        dirs = {}
        for name, text in variants((csrc / "log_mel_tf32.cu").read_text()).items():
            src = Path(tmp) / name / "csrc"
            shutil.copytree(csrc, src)
            (src / "log_mel_tf32.cu").write_text(text)
            dirs[name] = (src, Path(tmp) / name / "build")
        try:
            for _ in range(2):  # two rounds, the variants in turns
                for name, (src, build) in dirs.items():
                    _build.CSRC, _build.BUILD_DIR = src, build
                    _build._library.cache_clear()
                    ms = cuda_ms(lambda: fused_frontend.fused_log_mel_raw(wav), args.iters)
                    times.setdefault(name, []).append(ms)
        finally:
            _build.CSRC, _build.BUILD_DIR = csrc, build_dir
            _build._library.cache_clear()
    report = {"device": torch.cuda.get_device_name(0), "batch": args.batch, "secs": args.secs,
              **{f"{name}_ms": ms for name, ms in times.items()}}
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
