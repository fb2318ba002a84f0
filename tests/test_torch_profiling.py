"""The port's observability modules against the JAX package's:
``utils/profiling.py`` (the cases of ``tests/test_profiling_rtfx.py`` in
their torch forms: ``trace`` writes a file, ``checked`` raises on a NaN
and on a division by zero and keeps ``.checkified``, the NaN-debug toggle
restores its state, per-device memory stats), ``evals/rtfx.py``
(``measure_rtfx`` counts audio seconds, syncs every call and cycles
distinct warmed buffers) and ``utils/logging.py`` (``MetricsLogger``
writes the JAX logger's keys; ``train_loop`` takes a ``logger``)."""

import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jiao_liao_speech_recognition_tpu.utils.logging import MetricsLogger as JLogger  # noqa: E402
from jiao_liao_speech_recognition_torch.evals.rtfx import RTFxResult, measure_rtfx  # noqa: E402
from jiao_liao_speech_recognition_torch.utils import logging as tlog  # noqa: E402
from jiao_liao_speech_recognition_torch.utils.profiling import (  # noqa: E402
    NAN_DEBUG,
    annotate,
    checked,
    device_memory_stats,
    enable_nan_debug,
    trace,
)


def test_checked_raises_on_division_by_zero():
    def bad(x):
        return x / torch.zeros_like(x)

    with pytest.raises(FloatingPointError, match="division by zero"):
        checked(bad)(torch.ones(4))
    with pytest.raises(FloatingPointError, match="division by zero"):
        checked(lambda x: torch.remainder(x, 0))(torch.ones(4))
    with pytest.raises(FloatingPointError, match="division by zero"):
        checked(lambda x: 1.0 / (x - 1.0))(torch.ones(4))  # the reflected operator


def test_checked_passes_through_clean_fn_and_exposes_raw_form():
    def good(x):
        return x * 2.0 / 4.0

    wrapped = checked(good)
    np.testing.assert_allclose(wrapped(torch.ones(4)).numpy(), 0.5)
    err, out = wrapped.checkified(torch.ones(4))
    assert err is None
    np.testing.assert_allclose(out.numpy(), 0.5)
    err, out = checked(lambda x: x.log()).checkified(-torch.ones(2))
    assert isinstance(err, FloatingPointError) and out is None


def test_checked_surfaces_nan_from_inside_the_function():
    def nan_inside(x):
        y = torch.log(x)  # log(-1): NaN, then hidden from the output
        return torch.nan_to_num(y)

    with pytest.raises(FloatingPointError, match="NaN"):
        checked(nan_inside)(-torch.ones(2))
    with pytest.raises(FloatingPointError, match="NaN or Inf"):
        checked(lambda x: {"out": [x * float("inf")]})(torch.ones(2))


def test_enable_nan_debug_toggles_and_restores():
    before = torch.is_anomaly_enabled()
    enable_nan_debug(True)
    try:
        assert NAN_DEBUG.enabled and torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.log(-torch.ones(2))
    finally:
        enable_nan_debug(False)
    assert not NAN_DEBUG.enabled and torch.is_anomaly_enabled() == before
    assert torch.isnan(torch.log(-torch.ones(1))).all()


def test_trace_none_is_noop_and_annotate_nests():
    with trace(None):
        with annotate("featurize"):
            assert float(torch.ones(4).sum()) == 4.0


def test_trace_writes_profile_to_logdir(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        with annotate("featurize"):
            float(torch.ones(8, 8).sum())
    files = [os.path.join(r, f) for r, _, fs in os.walk(logdir) for f in fs]
    assert files, "torch.profiler wrote nothing"
    events = json.loads(open(files[0]).read())["traceEvents"]
    assert any(e.get("name") == "featurize" for e in events)


def test_device_memory_stats_keys_every_device():
    stats = device_memory_stats()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert len(stats) == n
    for v in stats.values():
        assert sorted(v) == ["bytes_in_use", "bytes_limit", "peak_bytes_in_use"]


def test_measure_rtfx_counts_audio_seconds_and_syncs():
    calls = []

    def infer(wav, lengths):
        return wav.sum(dim=1), lengths

    def spy_sync(out):
        calls.append(1)
        return int(out[1][0])

    res = measure_rtfx(infer, batch=2, chunk_seconds=0.05, iters=4, num_buffers=2, sync=spy_sync,
                       device="cpu")
    assert isinstance(res, RTFxResult)
    assert res.iters == 4 and res.rtfx > 0
    assert res.audio_seconds_per_batch == pytest.approx(0.1)
    assert len(calls) == 2 + 4  # warm once a buffer + once a timed iteration
    j = res.to_json()
    assert sorted(j) == ["metric", "seconds_per_batch", "unit", "value"]
    assert j["metric"] == "rtfx" and j["unit"] == "audio_sec_per_sec_per_chip"
    assert j["value"] == pytest.approx(res.rtfx, abs=0.01)
    # the default sync reads one element of the first output
    assert measure_rtfx(infer, batch=1, chunk_seconds=0.01, iters=1, device="cpu").iters == 1


def test_measure_rtfx_uses_distinct_buffers():
    seen = []

    def infer(wav, lengths):
        seen.append((wav.data_ptr(), wav.numpy().tobytes()))
        assert lengths.dtype == torch.int32 and int(lengths[0]) == wav.shape[1]
        return [torch.zeros(1)]

    measure_rtfx(infer, batch=1, chunk_seconds=0.01, iters=2, num_buffers=2, device="cpu")
    assert seen[0][1] != seen[1][1] and seen[0][0] != seen[1][0]
    assert [s[0] for s in seen[2:]] == [seen[0][0], seen[1][0]]  # cycled in turn


def test_metrics_logger_writes_the_jax_loggers_keys(tmp_path):
    recs = {}
    for name, cls in (("torch", tlog.MetricsLogger), ("jax", JLogger)):
        stream = io.StringIO()
        with cls(str(tmp_path / name / "m.jsonl"), stream=stream) as logger:
            logger.log(10, loss=np.float32(1.25), lr=1e-4)
            logger.log(20, event="sigterm_checkpoint_and_exit")
        lines = (tmp_path / name / "m.jsonl").read_text().splitlines()
        assert lines == stream.getvalue().splitlines()
        recs[name] = [json.loads(line) for line in lines]
    for got, want in zip(recs["torch"], recs["jax"]):
        assert list(got) == list(want)  # step, ts, then the metrics, in order
        assert {k: v for k, v in got.items() if k != "ts"} == \
            {k: v for k, v in want.items() if k != "ts"}
    assert recs["torch"][0]["loss"] == 1.25
    echo = tlog.echo_logger()
    assert echo._stream is not None and echo._fh is None


def test_metrics_logger_without_wandb_keeps_writing(tmp_path, capsys):
    with tlog.MetricsLogger(str(tmp_path / "m.jsonl"), use_wandb=True) as logger:
        logger.log(1, loss=0.5)
    assert json.loads((tmp_path / "m.jsonl").read_text())["loss"] == 0.5
    try:
        import wandb  # noqa: F401
    except ImportError:
        assert "wandb sink off" in capsys.readouterr().err


def test_train_loop_logs_through_the_logger_it_is_given(tmp_path):
    from test_torch_train import _corpus, _fresh, _train_cfg

    from jiao_liao_speech_recognition_torch.data import manifest as tman
    from jiao_liao_speech_recognition_torch.train import engine as teng

    manifest = _corpus(tmp_path)
    cfg = _train_cfg(tmp_path, manifest, total=2, log_every_steps=1,
                     metrics_path=str(tmp_path / "own.jsonl"))
    tok, model = _fresh(cfg, manifest)
    stream = io.StringIO()
    logger = tlog.MetricsLogger(stream=stream)
    teng.train_loop(cfg, tman.read_manifest(manifest), tok, model, logger=logger, kernels=False)
    recs = [json.loads(line) for line in stream.getvalue().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(list(r)[:2] == ["step", "ts"] and {"loss", "steps_per_sec"} <= set(r)
               for r in recs)
    assert not (tmp_path / "own.jsonl").exists()  # a given logger replaces metrics_path's
    logger.log(3, still="open")  # the loop leaves the caller's logger open
    # without one, the loop opens metrics_path's and closes it
    tok, model = _fresh(cfg, manifest)
    cfg.train.checkpoint_dir = str(tmp_path / "ckpt2")
    teng.train_loop(cfg, tman.read_manifest(manifest), tok, model, kernels=False)
    own = [json.loads(line) for line in (tmp_path / "own.jsonl").read_text().splitlines()]
    assert [r["step"] for r in own] == [1, 2]
