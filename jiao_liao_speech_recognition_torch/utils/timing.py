"""Device time of GPU work, for the port's profilers (``examples/torch_*``)."""

from __future__ import annotations

import itertools
import sys
import time

# the card's top SM clock (H100 SXM: 1980 MHz), to turn seconds into the
# cycles torch.cuda._sleep spins; a lower clock only lengthens the spin
_SPIN_HZ = 1.98e9


# device_ms's agreement rule: two profiler sessions of the same calls within
# SESSION_SHARE of each other, and their mean within SESSION_SHARE of
# queued_ms of the same calls, less GAP_US a launch (the device's gap
# between two queued launches, 1-2 us, which queued_ms counts and the
# profiler's kernel sum leaves out)
SESSION_SHARE = 0.1
GAP_US = 2.0


def device_ms(fn, iters: int = 20, attempts: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``: the CUDA kernels and
    copies it issues, summed by torch.profiler, after one warm call. (A
    short kernel timed with CUDA events around a Python loop measures the
    host's dispatch.) A profiler session on the card has returned no device
    events at all, and another a quarter less than the next: so each
    attempt runs two sessions and holds their sums against each other and
    against ``queued_ms`` of the same calls (SESSION_SHARE, GAP_US). An
    attempt that disagrees is made again, and after ``attempts`` of them
    the calls are timed by ``queued_ms`` instead, with a note on stderr."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        (a, launches_a), (b, launches_b) = _profiled_us(fn, iters), _profiled_us(fn, iters)
        if min(a, b) <= 0 or abs(a - b) > SESSION_SHARE * max(a, b):
            continue
        queued_us = queued_ms(fn, iters) * 1e3 * iters
        mean = (a + b) / 2
        floor = (queued_us - GAP_US * max(launches_a, launches_b)) * (1 - SESSION_SHARE)
        if floor <= mean <= queued_us * (1 + SESSION_SHARE):
            return mean / 1e3 / iters
    print(f"device_ms: {attempts} pairs of profiler sessions saw no device time or "
          "disagreed; timing with CUDA events behind a spin kernel", file=sys.stderr)
    return queued_ms(fn, iters)


def _profiled_us(fn, iters: int) -> tuple[float, int]:
    """(device microseconds, device launches) of ``iters`` calls of ``fn``
    in one profiler session ((0, 0) if the session saw no device event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.device_time_total]
    return sum(e.device_time_total for e in events), sum(e.count for e in events)


def queued_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn`` from CUDA events, with the
    calls queued behind a spin kernel that outlasts twice the host's time to
    issue them (1 ms at least): the first call starts only once all are queued, so the events
    bracket the device's work and not the host's dispatch (unless ``fn``
    waits on the device, which then counts as with CUDA events alone). It
    also counts the device's gap of 1-2 us between two queued launches,
    which the profiler's kernel sum leaves out."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(2 * host_s, 1e-3) * _SPIN_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cycling(fn, inputs):
    """-> a no-argument call of fn on each of `inputs` in turn (distinct
    buffers, so no call finds the previous one's input in the L2 cache)."""
    it = itertools.cycle(inputs)
    return lambda: fn(next(it))
