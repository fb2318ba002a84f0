"""utils/timing.device_ms: profiler sessions that see no device time are
run again, and after the last one the calls are timed by queued_ms. The
profiler and the card are stood in for, so this runs on the CPU."""

import pytest
import torch

from jiao_liao_speech_recognition_torch.utils import timing


@pytest.mark.parametrize("sessions_us, expect_ms, expect_fallback", [
    ([400.0], 0.02, False),            # the first session sees the work
    ([0.0, 0.0, 600.0], 0.03, False),  # two empty sessions, the third sees it
    ([0.0, 0.0, 0.0], 7.5, True),      # every session empty: CUDA events
])
def test_device_ms_retries_empty_profiler_sessions(monkeypatch, capsys, sessions_us,
                                                   expect_ms, expect_fallback):
    calls, sessions = [], list(sessions_us)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(timing, "_profiled_us", lambda fn, iters: sessions.pop(0))
    monkeypatch.setattr(timing, "queued_ms", lambda fn, iters: 7.5)
    ms = timing.device_ms(lambda: calls.append(1), iters=20, attempts=3)
    assert ms == pytest.approx(expect_ms)
    assert len(calls) == 1  # the warm call; the sessions are stood in for
    assert sessions == []   # no session more than needed
    assert ("no device time" in capsys.readouterr().err) == expect_fallback
