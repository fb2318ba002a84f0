"""Tracing, profiling and numeric debugging (the JAX package's
``utils/profiling.py``):

* ``trace(logdir)``: ``torch.profiler`` over the enclosed block (the host
  and, where there is a card, its kernels), written on exit as a Chrome
  trace ``<host>_<pid>.<ms>.pt.trace.json`` under `logdir`; a no-op for
  None. ``cli train`` and ``cli transcribe`` take it as ``--profile``.
* ``annotate(name)``: a ``record_function`` range that labels a stage.
* ``checked(fn, errors=None)``: torch has no checkify; the wrapper runs
  `fn` under a torch-function mode that raises ``FloatingPointError``
  where a division (``/``, ``div``, ``floor_divide``, ``remainder``,
  ``fmod``) meets a zero divisor (the div set) or an op makes a NaN, and
  where a floating output of `fn` holds a NaN (the NaN set) or an Inf (the
  float set). ``errors`` picks checkify's sets: ``FLOAT_CHECKS`` (NaN and
  div, as ``checkify.float_checks``), ``NAN_CHECKS``, ``DIV_CHECKS``, or
  JAX's own sets, read by their error classes' names. ``INDEX_CHECKS`` is refused:
  out-of-bounds indices go unchecked here. ``None`` takes the NaN and div
  checks. Each check reads the device (a sync), as checkify's error read
  does. ``checked(fn).checkified`` returns ``(err, out)`` instead of
  raising (err None when clean).
* ``enable_nan_debug(flag)``: ``torch.autograd.set_detect_anomaly`` (a
  NaN made in a backward raises) and ``checked``'s NaN check on every op
  of the process (as ``jax_debug_nans``); False restores the state
  before.
* ``device_memory_stats()``: per CUDA device, under JAX's keys.
"""

from __future__ import annotations

import contextlib
import functools
import numbers
from typing import Callable, Optional

import torch
from torch.overrides import TorchFunctionMode

_T = torch.Tensor
# function -> the position of its divisor in the call's arguments
_DIVISORS = {
    torch.div: 1, torch.true_divide: 1, torch.floor_divide: 1, torch.remainder: 1,
    torch.fmod: 1, _T.div: 1, _T.div_: 1, _T.true_divide: 1, _T.floor_divide: 1,
    _T.remainder: 1, _T.fmod: 1, _T.__truediv__: 1, _T.__itruediv__: 1,
    _T.__floordiv__: 1, _T.__mod__: 1, _T.__rtruediv__: 0, _T.__rfloordiv__: 0,
    _T.__rmod__: 0,
}


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the enclosed block into `logdir` (no-op when it is None)."""
    if logdir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    """Label a region inside an active trace: ``with annotate("featurize"):``"""
    return torch.profiler.record_function(name)


def _has_zero(x) -> bool:
    if isinstance(x, torch.Tensor):
        return bool((x == 0).any())
    return isinstance(x, numbers.Number) and x == 0


def _nonfinite(x, inf: bool) -> bool:
    if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
        return False
    return bool((~torch.isfinite(x)).any() if inf else torch.isnan(x).any())


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _leaves(t)
    else:
        yield tree


class _Checks(TorchFunctionMode):
    """Raise on a zero divisor (`div`) and on a NaN any op makes (`nan`)."""

    def __init__(self, div: bool = True, nan: bool = True):
        super().__init__()
        self.div, self.nan = div, nan

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.div and func in _DIVISORS:
            i = _DIVISORS[func]
            divisor = args[i] if len(args) > i else kwargs.get("other")
            if _has_zero(divisor):
                raise FloatingPointError(f"division by zero in {func.__name__}")
        out = func(*args, **kwargs)
        if self.nan and any(_nonfinite(t, inf=False) for t in _leaves(out)):
            raise FloatingPointError(f"NaN made by {func.__name__}")
        return out


# checkify's error sets, by category: an error class of JAX's sets maps
# to its category through its name (``_CATEGORIES``)
NAN_CHECKS = frozenset({"nan"})
DIV_CHECKS = frozenset({"div"})
FLOAT_CHECKS = NAN_CHECKS | DIV_CHECKS
INDEX_CHECKS = frozenset({"index"})
USER_CHECKS = frozenset({"user"})  # checkify.check calls: torch code makes none
_CATEGORIES = {"NaNError": "nan", "DivisionByZeroError": "div", "OOBError": "index",
               "FailedCheckError": "user"}


def check_categories(errors) -> frozenset:
    """`errors` (None, or categories and checkify error classes) -> the
    categories to check; the index set raises ``NotImplementedError``."""
    if errors is None:
        return FLOAT_CHECKS
    cats = set()
    for e in errors:
        name = e if isinstance(e, str) else getattr(e, "__name__", repr(e))
        cat = _CATEGORIES.get(name, name)
        if cat not in ("nan", "div", "index", "user"):
            raise ValueError(f"unknown check {e!r}")
        cats.add(cat)
    if "index" in cats:
        raise NotImplementedError(
            "checked(errors=...): the index set has no counterpart: torch has no checkify, "
            "and out-of-bounds indices go unchecked")
    return frozenset(cats)


def checked(fn: Callable, *, errors=None) -> Callable:
    """`fn` with the checks of `errors` (see ``check_categories``); raises
    ``FloatingPointError``. ``.checkified(*args, **kw) -> (err, out)``
    returns the error instead (out None then)."""
    cats = check_categories(errors)
    nan, inf = "nan" in cats, cats >= FLOAT_CHECKS  # an Inf out of the float set only

    def checkified(*args, **kwargs):
        try:
            with _Checks(div="div" in cats, nan=nan):
                out = fn(*args, **kwargs)
            if nan and any(_nonfinite(t, inf=inf) for t in _leaves(out)):
                raise FloatingPointError(f"a NaN or Inf in the output of {fn.__name__}")
        except FloatingPointError as e:
            return e, None
        return None, out

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        err, out = checkified(*args, **kwargs)
        if err is not None:
            raise err
        return out

    wrapper.checkified = checkified
    return wrapper


class NanDebug:
    """The process's NaN debugging state: anomaly detection and a NaN
    check on every op, pushed as a torch-function mode."""

    def __init__(self):
        self._mode: Optional[_Checks] = None
        self._anomaly = False

    @property
    def enabled(self) -> bool:
        return self._mode is not None

    def set(self, enable: bool) -> None:
        if enable and self._mode is None:
            self._anomaly = torch.is_anomaly_enabled()
            torch.autograd.set_detect_anomaly(True)
            self._mode = _Checks(div=False, nan=True)
            self._mode.__enter__()
        elif not enable and self._mode is not None:
            self._mode.__exit__(None, None, None)
            self._mode = None
            torch.autograd.set_detect_anomaly(self._anomaly)


NAN_DEBUG = NanDebug()


def enable_nan_debug(enable: bool = True) -> None:
    """Turn NaN debugging on (or off, restoring the state before)."""
    NAN_DEBUG.set(enable)


def device_memory_stats() -> dict:
    """{"cuda:i": {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}} for
    every CUDA device (empty without one)."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        out[f"cuda:{i}"] = {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
