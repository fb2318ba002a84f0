#!/usr/bin/env python3
"""The decode step's attention and logits kernels alone on one NVIDIA GPU:
K9 over bf16 and int8 head-major caches, each at a cross-attention cache
(Tk 1536, every row 1500 keys long) and a decoder self cache (Tk 256,
lengths 1-224), and K11 (int8 tied logits, R=16 rows against the [51866,
1280] table), at Whisper large-v3's B=16 decode shapes (20 heads of 64).

    python3 examples/torch_profile_decode_kernels.py [--root DIR] [--iters 20]

Each row times the kernel by device time (``utils.timing.device_ms``)
cycling through enough distinct inputs to exceed twice the 50 MB L2, as a
decode step finds them (0.9 GB streams between two reads of one layer's
cache); beside it the plain version, the least time the card could take
(bytes of the valid prefix over 3.35 TB/s, or the products over the bf16
peak), and one library call where one computes the same function: the
masked fused attention (``F.scaled_dot_product_attention`` with a boolean
key mask) for bf16 caches; none for int8 caches (K9 on bf16 caches of the
same shape is printed as context); cuBLAS's bf16 product on the
dequantized table for K11 (the bf16 operation it replaces). Then the SASS
of every K9 and K11 instance in the built library: its conversions from
integer to float (``I2F``), which the int8 instances need not issue.

``--root DIR`` imports the port from another checkout (a ``git archive``
of a parent commit), so one call can time parent, change, change, parent.
Prints one JSON line per row, then a summary line; ``main(argv)`` returns
the rows. Needs a CUDA device: without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

B, H, DH, D, V = 16, 20, 64, 1280, 51866  # large-v3 decode at B=16
T_ENC, MAX_LEN = 1500, 224
HBM_BYTES_S, BF16_OPS_S, L2_BYTES = 3.35e12, 989e12, 50e6


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / BF16_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def copies(set_bytes: float) -> int:
    """Distinct input sets whose bytes together exceed twice the L2 (two at least)."""
    return max(2, math.ceil(2 * L2_BYTES / set_bytes))


def decode_rows(iters: int = 20) -> dict:
    """-> {row name: {"ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
    ...}} for K9's four instances and K11, timed as the module docstring says."""
    import torch

    from torch.nn import functional as F

    from jiao_liao_speech_recognition_torch.ops import decode_attention as da
    from jiao_liao_speech_recognition_torch.ops import quant
    from jiao_liao_speech_recognition_torch.utils.timing import cycling, device_ms

    gen = torch.Generator(device="cuda").manual_seed(11)

    def randn(*shape, s=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * s

    bf = torch.bfloat16
    qh = randn(B, H, 1, DH).to(bf)
    tk_cross, tk_self = da.round_tk(T_ENC), da.round_tk(MAX_LEN)
    lens = {tk_cross: torch.full((B,), T_ENC, dtype=torch.int32, device="cuda"),
            tk_self: torch.from_numpy(
                np.random.RandomState(13).randint(1, MAX_LEN + 1, B)).int().cuda()}

    def caches(tk, int8):
        per_set = 2 * B * H * tk * (DH + 4 if int8 else 2 * DH)
        sets = []
        for _ in range(copies(per_set)):
            if int8:
                (kq, ks), (vq, vs) = (quant.quantize_kv(randn(B, H, tk, DH)) for _ in range(2))
                sets.append((kq, vq, {"k_scale": ks, "v_scale": vs}))
            else:
                sets.append((randn(B, H, tk, DH).to(bf), randn(B, H, tk, DH).to(bf), {}))
        return sets

    # the kernels' calls first, then the library's and the plain versions':
    # a process's first profiler sessions are the ones that always see the
    # device (later ones have fallen back on queued_ms)
    rows, calls = {}, {}
    with torch.inference_mode():
        for tk, where in ((tk_cross, "cross"), (tk_self, "self")):
            n = H * sum(int(t) for t in lens[tk].tolist())  # valid keys, every (b, h)
            io = B * H * DH * (2 + 4) + B * 4
            lt = lens[tk]
            mask = (torch.arange(tk, device="cuda")[None, :] < lt[:, None].long())
            for int8 in (False, True):
                name = f"K9{'-int8' if int8 else ''} {where}"
                sets = caches(tk, int8)
                calls[name] = (
                    cycling(lambda s, lt=lt: da.grouped_decode_attention(qh, s[0], s[1], lt, **s[2]),
                            sets),
                    cycling(lambda s, lt=lt: da.decode_attention_plain(qh, s[0], s[1], lt, **s[2]),
                            sets),
                    None if int8 else cycling(lambda s, m=mask: F.scaled_dot_product_attention(
                        qh, s[0], s[1], attn_mask=m[:, None, None, :]), sets))
                b_ms, b_by = bound_ms(io + 2 * n * (DH + 4 if int8 else 2 * DH), 4.0 * n * DH)
                rows[name] = {"bound_ms": b_ms, "bound_by": b_by, "input_sets": len(sets),
                              "shape": f"B={B}, {H} x {DH}, Tq=1, Tk={tk} ({where}, lengths "
                                       + (f"{T_ENC})" if where == "cross" else f"1-{MAX_LEN})"),
                              "library": None if int8 else "masked SDPA (boolean key mask)"}
        x = randn(B, D).to(bf)
        tables = []
        for _ in range(copies(V * D)):
            q, s = quant.quantize_int8(randn(V, D, s=D ** -0.5).t())
            tables.append((q.t().contiguous(), s))
        deq = [(q.float() * s[:, None]).to(bf) for q, s in tables]
        calls["K11"] = (cycling(lambda t: quant.int8_logits(x, *t), tables),
                        cycling(lambda t: quant.int8_tied_logits_plain(x, *t), tables),
                        cycling(lambda w: torch.matmul(x, w.t()), deq))
        b_ms, b_by = bound_ms(V * D + V * 4 + B * D * 2 + B * V * 4, 2.0 * B * V * D)
        rows["K11"] = {"bound_ms": b_ms, "bound_by": b_by, "input_sets": len(tables),
                       "shape": f"R={B}, V={V}, D={D}",
                       "library": "cuBLAS bf16 tied logits on the dequantized table"}
        for name, (kern, _, _) in calls.items():
            rows[name]["ms"] = device_ms(kern, iters)
        for name, (_, _, lib) in calls.items():
            rows[name]["library_ms"] = None if lib is None else device_ms(lib, iters)
        for name, (_, plain, _) in calls.items():
            rows[name]["plain_ms"] = device_ms(plain, 5)
    for name in ("cross", "self"):  # no library call attends over int8 caches
        rows[f"K9-int8 {name}"]["context_bf16_k9_ms"] = rows[f"K9 {name}"]["ms"]
    for row in rows.values():
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return rows


def sass_i2f() -> dict:
    """-> {kernel symbol: {I2F opcode: count}} for every K9 and K11 instance
    of the built library (``cuobjdump -sass``, beside nvcc). ``I2F.RP`` (and
    ``I2F.U32.RP``) is the first step of an integer division by a value
    known only at run time (a reciprocal rounded up); any other I2F converts
    a value, as an int8 cache or table byte once needed."""
    from jiao_liao_speech_recognition_torch import _build

    so, _ = _build.build()
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {}
            continue
        m = re.search(r"\b(I2F\S*)", line)
        if name and m:
            counts[name][m.group(1)] = counts[name].get(m.group(1), 0) + 1
    return {k: n for k, n in counts.items() if "decode_attention" in k or "tied_logits" in k}


def byte_conversions(i2f: dict) -> dict:
    """-> {kernel symbol: I2F that are not an integer division's step} of
    the int8 K9 instances and K11's TMA kernel (sass_i2f's report)."""
    return {k: sum(n for op, n in ops.items() if not op.endswith(".RP"))
            for k, ops in i2f.items()
            if "decode_attention_kernelIa" in k or "tied_logits_tma" in k}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose port is imported")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_decode_kernels.py: needs a CUDA device", file=sys.stderr)
        raise SystemExit(2)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rows = decode_rows(args.iters)
    for name, row in rows.items():
        print(json.dumps({"row": name, **row}), flush=True)
    i2f = sass_i2f()
    print(json.dumps({"root": args.root, "card": card, "i2f": i2f,
                      "byte_conversions": byte_conversions(i2f),
                      "ms": {name: row["ms"] for name, row in rows.items()}}), flush=True)
    return rows


if __name__ == "__main__":
    main()
