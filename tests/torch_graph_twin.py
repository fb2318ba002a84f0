"""A CPU twin of the port's CUDA graph capture (``utils/graphs.py``), shared
by the decode-loop tests: ``chunked(monkeypatch)`` makes the loops take
their captured route on the CPU, where each replay of a "captured" chunk
runs it eagerly, so the last chunk runs past the end, masked on the
device, as on the card."""

from jiao_liao_speech_recognition_torch.utils import graphs


class ReplayedOnCPU:
    """graphs.CapturedStep's CPU twin: warms as the card does (unless the
    loop ran its warm-up already), and each replay runs the captured chunk
    eagerly. ``made`` keeps every twin made since ``chunked``; each notes
    how many decode steps of ``calls`` (a test's count) ran before its
    capture, and the generator handed to it."""

    made = []
    calls = []

    def __init__(self, step, tally=False, warmed=False, generator=None):
        if not warmed:
            step()
        self.step, self.launches, self.capture_s = step, {}, 0.0
        self.generator = generator
        self.steps_before_capture = len(ReplayedOnCPU.calls)
        ReplayedOnCPU.made.append(self)

    def replay(self):
        self.step()


def chunked(monkeypatch) -> None:
    """Every loop captures, through the twin, warming in place."""
    ReplayedOnCPU.made = []
    monkeypatch.setattr(graphs, "capturing", lambda *a, **k: True)
    monkeypatch.setattr(graphs, "CapturedStep", ReplayedOnCPU)
    monkeypatch.setattr(graphs, "warm", lambda fn, tally=False: fn())
