"""RTFx harness: audio seconds transcribed per wall-clock second (the JAX
package's ``evals/rtfx.py``).

* distinct input buffers, cycled through the timed iterations (an
  identical dispatch can be served from a cache upstream of the work);
* every buffer warmed once before timing (the first call of a shape pays
  the kernels' build and the allocator's growth);
* a hard host sync each iteration: by default ``torch.cuda.synchronize()``
  and a read of one element of the first output.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


@dataclass
class RTFxResult:
    rtfx: float
    seconds_per_batch: float
    audio_seconds_per_batch: float
    iters: int

    def to_json(self) -> dict:
        return {
            "metric": "rtfx",
            "value": round(self.rtfx, 2),
            "unit": "audio_sec_per_sec_per_chip",
            "seconds_per_batch": round(self.seconds_per_batch, 5),
        }


def _first_leaf(tree):
    while isinstance(tree, (list, tuple, dict)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def default_sync(out) -> None:
    """Wait for the card, then read one element of the first output."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    leaf = _first_leaf(out)
    if isinstance(leaf, torch.Tensor):
        leaf.reshape(-1)[0].item()


def measure_rtfx(
    infer: Callable,  # (wav [B, L] f32, lengths [B] i32) -> outputs
    batch: int,
    chunk_seconds: float,
    sample_rate: int = 16000,
    iters: int = 10,
    num_buffers: int = 2,
    seed: int = 0,
    sync: Optional[Callable] = None,
    device="cuda",
) -> RTFxResult:
    """Time `iters` calls of `infer` on `num_buffers` distinct seeded
    batches of `batch` x `chunk_seconds` of audio on `device`, each buffer
    warmed first, with `sync` (default ``default_sync``) after every call."""
    samples = int(chunk_seconds * sample_rate)
    rng = np.random.RandomState(seed)
    base = rng.randn(batch, samples).astype(np.float32) * 0.1
    wavs = [torch.from_numpy(np.roll(base, i + 1, axis=0) + 1e-4 * (i + 1)).to(device)
            for i in range(num_buffers)]
    lengths = torch.full((batch,), samples, dtype=torch.int32, device=device)
    sync = sync or default_sync

    for w in wavs:
        sync(infer(w, lengths))

    t0 = time.perf_counter()
    for i in range(iters):
        sync(infer(wavs[i % num_buffers], lengths))
    dt = time.perf_counter() - t0

    audio = chunk_seconds * batch
    return RTFxResult(rtfx=audio * iters / dt, seconds_per_batch=dt / iters,
                      audio_seconds_per_batch=audio, iters=iters)
