#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, one JSON line each (any failed check raises; the script then exits
non-zero and prints no result line):

1. device  - the card's name and power limit from nvidia-smi;
2. build   - compile the four CUDA kernels from csrc/ with nvcc (sm_90a);
3. kernels - each kernel against its plain PyTorch version at main-path
             shapes, with the bars stated below;
4. e2e     - api.load of the full-width flagship (12 x d512, 4 heads of 128,
             mlp 2048, V 4336, random init from seed 0) and api.transcribe of
             six requests (0.5 s to 42 s; the last is chunked in two), plain
             and with timestamps; every kernel's launch count must rise; the
             same requests through the plain versions on the card must agree;
5. timing  - seconds per batch of 32 x 30 s through the kernel path and the
             plain path, and each kernel alone against its plain version.

Then a line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.
There is no CPU path: without CUDA the script exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# --- bars -----------------------------------------------------------------
# K1: the JAX package's log-mel parity bar (docs/COMPONENTS.md C3), on the
# Whisper-normalized surface. Both sides are full f32; only summation order
# differs.
LOGMEL_BAR = 2e-4
# K2, K3: max |kernel - plain| <= ULP_BAR bf16 ulps of the output magnitude
# (the ulp of max |plain|). Both round to bf16 at the same points and differ
# only in the order of f32 sums, which can flip a rounding of an
# intermediate by one ulp; the output itself passes three roundings (product,
# + residual, + bias). The per-element figure (ulps of each element's own
# magnitude, floored at the mean) is printed too: it read 3 on K2's first run.
ULP_BAR = 2.0
# K4 and the end-to-end ids: compared on every frame whose plain top-2 logit
# margin exceeds ARGMAX_MARGIN. K4 alone differs from its plain version by
# f32 summation order (~1e-4 on logits of O(1)); end to end, bf16 rounding
# flips compound through 12 blocks. At least MIN_COVERAGE of the frames must
# clear the margin, or the comparison would be hollow.
ARGMAX_MARGIN = 0.05
MIN_COVERAGE = 0.5

KERNELS = [  # name, wrapper module, CUDA source, TPU kernel it replaces
    ("K1 fused_log_mel_raw", "frontend.fused_frontend", "csrc/log_mel.cu",
     "jiao_liao_speech_recognition_tpu/frontend/pallas_frontend.py:91"),
    ("K2 fused_attention_sublayer", "ops.fused_attention", "csrc/attention.cu",
     "jiao_liao_speech_recognition_tpu/ops/fused_attention.py:163"),
    ("K3 fused_ln_mlp_residual", "ops.fused_mlp", "csrc/mlp.cu",
     "jiao_liao_speech_recognition_tpu/ops/fused_mlp.py:180"),
    ("K4 fused_head_argmax", "ops.fused_head", "csrc/head.cu",
     "jiao_liao_speech_recognition_tpu/ops/fused_head.py:78"),
]
PKG = "jiao_liao_speech_recognition_torch"
SAMPLE_RATE = 16000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def bf16_ulp_err(got, want):
    """-> (max |got - want| in bf16 ulps of max |want|, the same per element
    in ulps of max(|want_i|, mean |want|), share of elements over 1 such ulp)."""
    import torch

    def ulp(v):
        return torch.exp2(torch.floor(torch.log2(v.clamp_min(2.0 ** -126))) - 7)

    w = want.float()
    diff = (got.float() - w).abs()
    per_elem = diff / ulp(torch.maximum(w.abs(), w.abs().mean()))
    return (float(diff.max() / ulp(w.abs().max())), float(per_elem.max()),
            float((per_elem > 1).float().mean()))


def margins(logits):
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device milliseconds per call (CUDA events), after a warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --- phases -----------------------------------------------------------------


def phase_device():
    import torch

    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(line, flush=True)
    name, limit = (s.strip() for s in line.split(",", 1))
    emit({"phase": "device", "name": name, "power_limit": limit,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})
    return line


def phase_build():
    from jiao_liao_speech_recognition_torch import _build

    so, seconds = _build.build()
    _build._library()  # load and bind every exported function
    emit({"phase": "build", "library": so.name, "seconds": seconds})


def _attn_args(rng, B, T, d, lens, dev):
    import torch

    def w(*shape, s=0.05):
        return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32)).to(dev)

    x = torch.from_numpy(rng.randn(B, T, d).astype(np.float32)).to(dev, torch.bfloat16)
    g = 1.0 + w(d, s=0.1)
    bl = w(d, s=0.1)
    return (x, g, bl, w(d, d), w(d), w(d, d), w(d, d), w(d), w(d, d), w(d),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def phase_kernels():
    """Each kernel against its plain version at main-path shapes."""
    import torch

    from jiao_liao_speech_recognition_torch.frontend import features, fused_frontend
    from jiao_liao_speech_recognition_torch.ops import fused_attention, fused_head, fused_mlp
    from jiao_liao_speech_recognition_torch.utils.config import FrontendConfig

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    errs = {}
    B, T, d = 4, 750, 512
    lens = [750, 600, 313, 1]

    # K1: 30 s of tone + noise, quieter in two rows (deeper spectral valleys)
    fe = FrontendConfig()
    t = np.arange(30 * SAMPLE_RATE) / SAMPLE_RATE
    wav = np.stack([
        a * np.sin(2 * np.pi * f * t) + n * rng.randn(len(t))
        for a, f, n in ((0.3, 440.0, 0.05), (0.1, 1200.0, 0.01), (0.0, 1.0, 0.1), (0.02, 300.0, 0.0005))
    ]).astype(np.float32)
    wav_d = torch.from_numpy(wav).to(dev)
    got = features.normalize_log_mel(fused_frontend.fused_log_mel_raw(wav_d), fe)
    want = features.normalize_log_mel(fused_frontend.log_mel_raw_plain(wav_d), fe)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    emit({"phase": "kernels", "kernel": "K1", "shape": list(wav.shape),
          "max_abs_err": err, "bar": LOGMEL_BAR})
    check(err <= LOGMEL_BAR, f"K1 log-mel error {err} > {LOGMEL_BAR}")
    errs["K1"] = err

    # K2 at both head widths, ragged lengths including 1
    for heads in (4, 8):
        args = _attn_args(rng, B, T, d, lens, dev)
        got = fused_attention.fused_attention_sublayer(*args, heads)
        want = fused_attention.attention_sublayer_plain(*args, heads)
        torch.cuda.synchronize()
        ulps, elem_ulps, over1 = bf16_ulp_err(got, want)
        err = float((got.float() - want.float()).abs().max())
        emit({"phase": "kernels", "kernel": "K2", "heads": heads, "dh": d // heads,
              "max_abs_err": err, "ulps": ulps, "bar_ulps": ULP_BAR,
              "elementwise_max_ulps": elem_ulps, "elementwise_share_over_1ulp": over1})
        check(ulps <= ULP_BAR, f"K2 (H={heads}) off by {ulps} bf16 ulps")
        if heads == 4:
            errs["K2"] = err

    # K3, both GELU forms
    for form in ("tanh", "erf"):
        x = torch.from_numpy(rng.randn(B, T, d).astype(np.float32)).to(dev, torch.bfloat16)
        p = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            1.0 + 0.1 * rng.randn(d), 0.1 * rng.randn(d),
            0.05 * rng.randn(d, 4 * d), 0.05 * rng.randn(4 * d),
            0.05 * rng.randn(4 * d, d), 0.05 * rng.randn(d))]
        got = fused_mlp.fused_ln_mlp_residual(x, *p, 1e-5, form)
        want = fused_mlp.ln_mlp_residual_plain(x, *p, 1e-5, form)
        torch.cuda.synchronize()
        ulps, elem_ulps, over1 = bf16_ulp_err(got, want)
        err = float((got.float() - want.float()).abs().max())
        emit({"phase": "kernels", "kernel": "K3", "gelu_form": form,
              "max_abs_err": err, "ulps": ulps, "bar_ulps": ULP_BAR,
              "elementwise_max_ulps": elem_ulps, "elementwise_share_over_1ulp": over1})
        check(ulps <= ULP_BAR, f"K3 ({form}) off by {ulps} bf16 ulps")
        if form == "tanh":
            errs["K3"] = err

    # K4 at V=4336, then two forced ties (across and within a 128-column chunk)
    V = 4336
    x = torch.from_numpy(rng.randn(B, T, d).astype(np.float32)).to(dev, torch.bfloat16)
    w = torch.from_numpy((rng.randn(d, V) / np.sqrt(d)).astype(np.float32)).to(dev)
    b = torch.from_numpy((0.1 * rng.randn(V)).astype(np.float32)).to(dev)
    got = fused_head.fused_head_argmax(x, w, b)
    logits = fused_head.head_logits(x, w, b)
    want = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    clear = margins(logits) > ARGMAX_MARGIN
    coverage = float(clear.float().mean())
    mismatch = int(((got != want) & clear).sum())
    emit({"phase": "kernels", "kernel": "K4", "V": V, "coverage": coverage,
          "mismatched_frames": mismatch, "margin": ARGMAX_MARGIN,
          "agree_all_frames": float((got == want).float().mean())})
    check(coverage >= MIN_COVERAGE and mismatch == 0, "K4 ids disagree with the plain argmax")
    errs["K4"] = float((got - want).abs()[clear].max())  # ids: 0 when all agree
    for first, second in ((7, 4000), (130, 250)):
        wt, bt = w.clone(), b.clone()
        wt[:, second] = wt[:, first]
        bt[first] = bt[second] = 100.0
        ids = fused_head.fused_head_argmax(x, wt, bt)
        check(bool((ids == first).all()), f"K4 tie {first}/{second}: not the first index")
    emit({"phase": "kernels", "kernel": "K4", "ties": "first index wins"})
    return errs


def make_requests(seed: int = 0):
    """Six requests of 0.5, 3, 7.5, 12, 30 and 42 s: tones and noise."""
    rng = np.random.RandomState(seed)
    out = []
    for secs in (0.5, 3.0, 7.5, 12.0, 30.0, 42.0):
        t = np.arange(int(secs * SAMPLE_RATE)) / SAMPLE_RATE
        f = rng.uniform(150.0, 2000.0)
        out.append((0.2 * np.sin(2 * np.pi * f * t) * np.sin(2 * np.pi * 0.5 * t)
                    + 0.05 * rng.randn(len(t))).astype(np.float32))
    return out


def phase_e2e(counters):
    import torch

    from jiao_liao_speech_recognition_torch import api
    from jiao_liao_speech_recognition_torch.data.tokenizer import CharTokenizer
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch
    from jiao_liao_speech_recognition_torch.utils.config import ExperimentConfig

    cfg = ExperimentConfig()
    bundle = api.load(config=cfg, device="cuda")
    m = cfg.ctc_model
    n_params = sum(p.numel() for p in bundle.model.parameters())
    # one character per non-special id, so every id decodes to text
    bundle.tokenizer = CharTokenizer([chr(0x4E00 + i) for i in range(m.vocab_size - 2)])
    requests = make_requests()

    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    texts = api.transcribe(bundle, requests)
    timed = api.transcribe(bundle, requests, timestamps=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {c.name: c.launches for c in counters}

    emit({"phase": "e2e", "params": n_params, "layers": m.num_layers, "d_model": m.d_model,
          "heads": m.num_heads, "mlp": m.mlp_dim, "vocab": m.vocab_size,
          "requests_s": [len(r) / SAMPLE_RATE for r in requests],
          "text_chars": [len(s) for s in texts], "seconds_both_calls": seconds,
          "launches": launches})
    check(len(texts) == len(requests) and all(isinstance(s, str) for s in texts),
          "one transcript per request")
    check(sum(len(s) for s in texts) > 0, "random-init model emitted no text at all")
    check(all(v > 0 for v in launches.values()), f"a kernel never ran: {launches}")
    joined = ["".join(tok["token"] for tok in utt) for utt in timed]
    check(joined == texts, "timestamped tokens do not concatenate to the greedy text")
    check(all(tok["end"] <= len(r) / SAMPLE_RATE + 0.04 for utt, r in zip(timed, requests)
              for tok in utt), "a timestamp runs past its audio")

    # the same requests through the plain versions on the card
    fe = cfg.frontend
    wavs, alens, _ = bundle._prepare_audio_chunked(requests, None)
    with torch.inference_mode():
        wav = torch.from_numpy(wavs).cuda()
        flens = torch.from_numpy(alens // fe.hop_length).cuda()
        feats_k = featurize_batch(wav, fe, kernels=True)
        feats_p = featurize_batch(wav, fe, kernels=False)
        ids_k, olens = bundle.model(feats_k, flens, head_mode="argmax_ids", kernels=True)
        log_probs, _ = bundle.model(feats_p, flens, head_mode="log_probs", kernels=False)
        torch.cuda.synchronize()
    logmel_err = float((feats_k - feats_p).abs().max())
    frames = torch.arange(ids_k.shape[1], device="cuda")[None, :] < olens[:, None]
    ids_p = log_probs.argmax(-1).to(torch.int32)
    clear = frames & (margins(log_probs) > ARGMAX_MARGIN)
    coverage = float(clear.sum() / frames.sum())
    mismatch = int(((ids_k != ids_p) & clear).sum())
    agree = float(((ids_k == ids_p) & frames).sum() / frames.sum())
    finite = bool(torch.isfinite(log_probs).all())
    emit({"phase": "e2e", "vs_plain": {
        "chunks": int(wavs.shape[0]), "logmel_max_abs_err": logmel_err, "logmel_bar": LOGMEL_BAR,
        "frames": int(frames.sum()), "coverage": coverage, "margin": ARGMAX_MARGIN,
        "mismatched_frames": mismatch, "agree_all_frames": agree}})
    check(finite and tuple(log_probs.shape) == (wavs.shape[0], 750, m.vocab_size),
          "plain log-probs are not finite [chunks, 750, V]")
    check(logmel_err <= LOGMEL_BAR, f"e2e log-mel error {logmel_err}")
    check(coverage >= MIN_COVERAGE and mismatch == 0, "e2e ids disagree with the plain path")
    return launches, bundle


def phase_timing(bundle):
    """32 x 30 s through both paths (turns: plain, kernels, kernels, plain),
    then each kernel alone against its plain version at the same shapes."""
    import torch

    from jiao_liao_speech_recognition_torch.decode.ctc import ctc_greedy_collapse
    from jiao_liao_speech_recognition_torch.frontend import fused_frontend
    from jiao_liao_speech_recognition_torch.frontend.features import featurize_batch
    from jiao_liao_speech_recognition_torch.ops import fused_attention, fused_head, fused_mlp

    fe = bundle.config.frontend
    B, L = 32, 30 * SAMPLE_RATE
    rng = np.random.RandomState(1)
    bufs = [torch.from_numpy((0.1 * rng.randn(B, L)).astype(np.float32)).cuda() for _ in range(2)]
    flens = torch.full((B,), L // fe.hop_length, dtype=torch.int32, device="cuda")

    @torch.inference_mode()
    def infer(wav, kernels):
        feats = featurize_batch(wav, fe, kernels=kernels)
        ids, olens = bundle.model(feats, flens, head_mode="argmax_ids", kernels=kernels)
        return ctc_greedy_collapse(ids, olens)

    times = {True: [], False: []}
    for kernels in (False, True):  # warm every buffer on both paths
        for w in bufs:
            infer(w, kernels)
    torch.cuda.synchronize()
    for kernels in (False, True, True, False):
        for i in range(4):
            t0 = time.perf_counter()
            infer(bufs[i % 2], kernels)
            torch.cuda.synchronize()
            times[kernels].append(time.perf_counter() - t0)
    kern_s, plain_s = statistics.median(times[True]), statistics.median(times[False])
    emit({"phase": "timing", "batch": B, "seconds_audio": 30.0,
          "kernel_path_s_per_batch": kern_s, "plain_path_s_per_batch": plain_s,
          "kernel_path_rtfx": B * 30.0 / kern_s, "plain_path_rtfx": B * 30.0 / plain_s,
          "kernel_path_samples_s": times[True], "plain_path_samples_s": times[False]})

    # kernels alone, B=32, T'=750, flagship weights of block 0
    blk = bundle.model.blocks[0]
    sa, ln1, ln2 = blk.self_attn, blk.self_attn_ln, blk.mlp_ln
    x = torch.from_numpy(rng.randn(B, 750, 512).astype(np.float32)).cuda().to(torch.bfloat16)
    lens = torch.full((B,), 750, dtype=torch.int32, device="cuda")
    attn_args = (x, ln1.scale, ln1.bias, sa.q_proj.kernel, sa.q_proj.bias, sa.k_proj.kernel,
                 sa.v_proj.kernel, sa.v_proj.bias, sa.out_proj.kernel, sa.out_proj.bias,
                 lens, sa.num_heads)
    mlp_args = (x, ln2.scale, ln2.bias, blk.mlp.fc1.kernel, blk.mlp.fc1.bias,
                blk.mlp.fc2.kernel, blk.mlp.fc2.bias, 1e-5, blk.mlp.gelu_form)
    head = bundle.model.ctc_head
    pairs = {
        "K1": (lambda: fused_frontend.fused_log_mel_raw(bufs[0]),
               lambda: fused_frontend.log_mel_raw_plain(bufs[0])),
        "K2": (lambda: fused_attention.fused_attention_sublayer(*attn_args),
               lambda: fused_attention.attention_sublayer_plain(*attn_args)),
        "K3": (lambda: fused_mlp.fused_ln_mlp_residual(*mlp_args),
               lambda: fused_mlp.ln_mlp_residual_plain(*mlp_args)),
        "K4": (lambda: fused_head.fused_head_argmax(x, head.kernel, head.bias),
               lambda: fused_head.head_argmax_plain(x, head.kernel, head.bias)),
    }
    ms = {}
    with torch.inference_mode():
        for key, (kern, plain) in pairs.items():
            p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
            ms[key] = ((k1 + k2) / 2, (p1 + p2) / 2)
            emit({"phase": "timing", "kernel": key, "shape": "B=32, 30 s / T'=750",
                  "ms": ms[key][0], "plain_ms": ms[key][1], "turns_ms": [p1, k1, k2, p2]})
    return ms


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke.py: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke run has no CPU path", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import importlib

        mods = [importlib.import_module(f"{PKG}.{mod}") for _, mod, _, _ in KERNELS]
    except ImportError as e:
        print(f"chip_smoke.py: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = [m.COUNTER for m in mods]

    phase_device()
    phase_build()
    errs = phase_kernels()
    launches, bundle = phase_e2e(counters)
    ms = phase_timing(bundle)
    table = []
    for (name, _, src, replaces), counter in zip(KERNELS, counters):
        key = name.split()[0]
        table.append({"name": name, "route": "cuda", "source": f"{PKG}/{src}",
                      "replaces": replaces, "launches": launches[counter.name],
                      "max_abs_err": errs[key], "ms": ms[key][0], "plain_ms": ms[key][1]})
    check(all(math.isfinite(r["ms"]) for r in table), "a timing is not finite")
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
