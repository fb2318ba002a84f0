"""Device time of GPU work, for the port's profilers (``examples/torch_*``)."""

from __future__ import annotations

import itertools


def device_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``: the CUDA kernels and
    copies it issues, summed by torch.profiler, after one warm call. (A
    short kernel timed with CUDA events around a Python loop measures the
    host's dispatch.) Raises if the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type.name == "CUDA" and e.device_time_total)
    if us <= 0:
        raise RuntimeError("the profiler saw no device time")
    return us / 1e3 / iters


def cycling(fn, inputs):
    """-> a no-argument call of fn on each of `inputs` in turn (distinct
    buffers, so no call finds the previous one's input in the L2 cache)."""
    it = itertools.cycle(inputs)
    return lambda: fn(next(it))
