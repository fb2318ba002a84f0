"""A CPU twin of the port's CUDA graph capture (``utils/graphs.py``), shared
by the decode-loop tests: ``chunked(monkeypatch)`` makes the loops take
their captured route on the CPU, where each replay of a "captured" chunk
runs it eagerly, so the last chunk runs past the end, masked on the
device, as on the card. ``captured_steps(monkeypatch)`` does the same for
the train step (``train/engine.TrainStep``), whose twin also keeps static
outputs that each replay rewrites."""

from jiao_liao_speech_recognition_torch.utils import graphs


class ReplayedOnCPU:
    """graphs.CapturedStep's CPU twin: warms as the card does (unless the
    loop ran its warm-up already), and each replay runs the captured chunk
    eagerly. ``made`` keeps every twin made since ``chunked``; each notes
    how many decode steps of ``calls`` (a test's count) ran before its
    capture, and the generator handed to it."""

    made = []
    calls = []

    def __init__(self, step, tally=False, warmed=False, generator=None, generators=(),
                 pool=None):
        if not warmed:
            step()
        self.step, self.launches, self.capture_s = step, {}, 0.0
        self.generator = generator
        self.generators, self.pool = list(generators), pool
        self.steps_before_capture = len(ReplayedOnCPU.calls)
        ReplayedOnCPU.made.append(self)

    def replay(self):
        self.step()


class StepReplayedOnCPU(ReplayedOnCPU):
    """The train step's twin (train/engine.TrainStep): ``out`` holds what a
    capture returns, tensors that every replay rewrites in place, as a
    graph's static outputs are; the card's capture runs nothing, so
    neither does this one's."""

    def __init__(self, step, tally=False, warmed=False, generator=None, generators=(),
                 pool=None):
        super().__init__(step, tally, warmed, generator, generators, pool)
        self.out = None

    def replay(self):
        got = self.step()
        if self.out is None:
            self.out = got
        else:
            for k, v in got.items():
                self.out[k].copy_(v)


def chunked(monkeypatch, twin=ReplayedOnCPU) -> None:
    """Every loop captures, through the twin, warming in place."""
    ReplayedOnCPU.made = []
    monkeypatch.setattr(graphs, "capturing", lambda *a, **k: True)
    monkeypatch.setattr(graphs, "CapturedStep", twin)
    monkeypatch.setattr(graphs, "warm", lambda fn, tally=False: fn())


def captured_steps(monkeypatch) -> None:
    """train_loop takes its captured route on the CPU: each bucket's first
    step runs as the warm-up, every later one as a replay of the twin."""
    chunked(monkeypatch, StepReplayedOnCPU)
