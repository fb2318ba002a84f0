"""Structured jsonl metrics logging with an optional wandb sink (the JAX
package's ``utils/logging.py``). Every record is one JSON line
``{"step": int, "ts": float, **metrics}``. wandb is imported only when
asked for and is never a hard dependency: where it is missing or its init
fails, the sink is off (said on stderr) and the jsonl records go on.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import IO, Mapping, Optional


class MetricsLogger:
    """Append-only jsonl metrics writer to a file, a stream or both.

    >>> logger = MetricsLogger("runs/exp1/metrics.jsonl")
    >>> logger.log(step=10, loss=1.23, lr=1e-4)
    """

    def __init__(self, path: Optional[str] = None, *, stream: Optional[IO[str]] = None,
                 use_wandb: bool = False, wandb_kwargs: Optional[Mapping] = None) -> None:
        self._fh: Optional[IO[str]] = None
        if path is not None:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._fh = p.open("a", buffering=1)
        self._stream = stream
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(**dict(wandb_kwargs or {}))
            except Exception as e:  # an optional sink: the run goes on without it
                print(f"MetricsLogger: wandb sink off ({e!r})", file=sys.stderr)

    def log(self, step: int, **metrics) -> None:
        line = json.dumps({"step": int(step), "ts": time.time(), **metrics}, default=float)
        if self._fh is not None:
            self._fh.write(line + "\n")
        if self._stream is not None:
            self._stream.write(line + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def echo_logger() -> MetricsLogger:
    """A logger that prints each record to stdout."""
    return MetricsLogger(stream=sys.stdout)
