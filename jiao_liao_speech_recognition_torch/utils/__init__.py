"""Utilities: config twins (config.py), jsonl metrics logging (logging.py),
profiling (profiling.py), native library loading (native_ext.py)."""

from . import config  # noqa: F401
from .logging import MetricsLogger  # noqa: F401
