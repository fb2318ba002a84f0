"""Production serving: the continuous-batching engine for Whisper AR decode
(``serve/engine.py``)."""

from .engine import ServingEngine, ServingStats

__all__ = ["ServingEngine", "ServingStats"]
