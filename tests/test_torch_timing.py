"""utils/timing.device_ms: each attempt runs two profiler sessions and holds
them against each other and against queued_ms of the same calls; an attempt
whose sessions saw no device time, or disagree, is made again, and after
the last one the calls are timed by queued_ms. The profiler and the card
are stood in for, so this runs on the CPU."""

import pytest
import torch

from jiao_liao_speech_recognition_torch.utils import timing

LAUNCHES = 20  # one launch a call, 20 calls a session


@pytest.mark.parametrize("sessions_us, queued, expect_ms, expect_fallback", [
    # both sessions see the work and queued_ms agrees
    ([400.0, 404.0], [0.021], 0.0201, False),
    # two attempts' sessions empty, the third's see it
    ([0.0, 0.0, 0.0, 0.0, 600.0, 600.0], [0.03], 0.03, False),
    # every session empty: CUDA events
    ([0.0] * 6, [7.5], 7.5, True),
    # one session undercounts once (a quarter less than the next): again
    ([300.0, 400.0, 400.0, 400.0], [0.0205], 0.02, False),
    # both sessions undercount alike, below queued_ms less the gaps: again
    ([300.0, 300.0, 400.0, 400.0], [0.02, 0.0205], 0.02, False),
], ids=["sessions_us0-0.02-False", "sessions_us1-0.03-False", "sessions_us2-7.5-True",
        "undercount-once", "undercount-alike"])
def test_device_ms_retries_empty_profiler_sessions(monkeypatch, capsys, sessions_us, queued,
                                                   expect_ms, expect_fallback):
    calls, sessions, queued = [], list(sessions_us), list(queued)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(timing, "_profiled_us",
                        lambda fn, iters: (sessions.pop(0), LAUNCHES if sessions_us else 0))
    monkeypatch.setattr(timing, "queued_ms", lambda fn, iters: queued.pop(0))
    ms = timing.device_ms(lambda: calls.append(1), iters=20, attempts=3)
    assert ms == pytest.approx(expect_ms)
    assert len(calls) == 1  # the warm call; the sessions are stood in for
    assert sessions == [] and queued == []  # no session or timing more than needed
    assert ("disagreed" in capsys.readouterr().err) == expect_fallback
