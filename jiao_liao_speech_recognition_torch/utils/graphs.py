"""CUDA graph capture of a step: the one rule that the serving engine
(serve/engine.py), the streaming pool (serve/streaming.py), the offline
decode loops (decode/whisper_generate.py, decode/speculative.py,
decode/ctc.py) and the train step (train/engine.TrainStep) share.

A step is warmed first: run eagerly on a side stream (``warm``), so the
kernels' library, cuBLAS's handles and workspaces, the serving copies, the
position tables and a split model's NCCL communicators exist before the
capture. The warm-up is real work: the engine and the pool warm with their
step on idle rows, the offline loops with their forced prompt steps and
their first generated step (one step at least, also under an empty
prompt), speculative greedy with its first pass, the CTC beam with its
first frame, the train step with a bucket's first step. Then the step is captured. The launch counters
(``_build.COUNTERS``) count the capture's launches, which run nothing:
they are kept as the step's ``launches`` by counter name and taken back
off the counters, so a path's launches are the counted ones plus
``launches`` x ``replays``. The offline loops also add every replay's
launches to ``TALLY``, which the phases of chip_smoke.py read beside the
counters. A step that draws from generators other than the default CUDA
one registers them with the graph, so each replay advances them as the
eager draws would, or reads the seeds the host set before it. Graphs that
never run at once (the train step's, one a bucket) share one memory pool;
what one of them leaves in the pool is read before another replays. A
capture or replay that fails raises; nothing falls back to the eager step.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import torch

from .. import _build
from ..parallel.tp import check_capturable


class GraphTally:
    """The offline loops' replays since the last ``reset``: the launches
    they made by counter name, the replays, and the seconds the warm-ups
    and captures took."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.launches: Dict[str, int] = {}
        self.replays = 0
        self.capture_s = 0.0


TALLY = GraphTally()
_WARM_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _warm_stream() -> "torch.cuda.Stream":
    """The current device's warm-up stream, made once: cuBLAS keeps a
    workspace (32 MiB on the H100) for every stream it runs on, so a new
    stream a capture would hold that much a call until the process ends."""
    dev = torch.cuda.current_device()
    if dev not in _WARM_STREAMS:
        _WARM_STREAMS[dev] = torch.cuda.Stream()
    return _WARM_STREAMS[dev]


def capturing(device: torch.device, graph: bool, model=None, who: str = "") -> bool:
    """Whether a loop on `device` captures its steps: on a card unless
    graph=False. A split `model` that cannot be captured raises
    (``parallel/tp.check_capturable``, naming graph=False)."""
    if not graph or torch.device(device).type != "cuda":
        return False
    if model is not None:
        check_capturable(model, device, who)
    return True


def warm(fn: Callable, tally: bool = False):
    """Run fn() once on the device's warm-up stream, ordered after the work
    queued so far and before the work queued next -> fn's result. With
    ``tally`` its seconds, to its end on the device, are added to
    ``TALLY.capture_s``."""
    t0 = time.perf_counter()
    side = _warm_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    if tally:
        torch.cuda.synchronize()
        TALLY.capture_s += time.perf_counter() - t0
    return out


class CapturedStep:
    """``step`` captured in a CUDA graph, after one eager run of it on the
    warm-up stream unless the caller ran its work there already
    (``warmed``: ``warm`` above). ``out`` is what the captured call returned
    (tensors the replays rewrite), ``launches`` the kernel launches of one
    replay by counter name, ``capture_s`` the seconds the warm-up and the
    capture took. ``generator`` and ``generators``, CUDA generators the step
    draws from, are registered with the graph (the default one always is).
    ``pool``, a ``torch.cuda.graph_pool_handle()`` or another graph's
    ``pool()``, is the memory pool the capture allocates from (a private one
    when None). With ``tally`` every replay is also added to ``TALLY``. The
    graph reads and writes the addresses of the state tensors `step`
    touched: their owner (the loop, the engine, the pool) keeps them alive
    while it replays; the object holds no reference to them, so an owner
    that holds it forms no cycle."""

    def __init__(self, step: Callable, tally: bool = False, warmed: bool = False,
                 generator: Optional[torch.Generator] = None,
                 generators: Sequence[torch.Generator] = (), pool=None):
        t0 = time.perf_counter()
        if not warmed:
            warm(step)
        torch.cuda.synchronize()
        before = {c: c.launches for c in _build.COUNTERS}
        self.graph = torch.cuda.CUDAGraph()
        for gen in ([generator] if generator is not None else []) + list(generators):
            self.graph.register_generator_state(gen)
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = step()
        self.launches: Dict[str, int] = {}
        for c, n in before.items():
            if c.launches != n:
                self.launches[c.name] = c.launches - n
                c.launches = n
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.tally = tally
        if tally:
            TALLY.capture_s += self.capture_s

    def replay(self) -> None:
        self.graph.replay()
        if self.tally:
            TALLY.replays += 1
            for name, n in self.launches.items():
                TALLY.launches[name] = TALLY.launches.get(name, 0) + n
