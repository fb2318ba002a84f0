"""Production serving: the continuous-batching engine for Whisper AR decode
(``serve/engine.py``) and sliding-window streaming transcription for the
CTC family (``serve/streaming.py``)."""

from .engine import ServingEngine, ServingStats
from .streaming import StreamingConfig, StreamingPool, StreamingResult, StreamingTranscriber

__all__ = [
    "ServingEngine",
    "ServingStats",
    "StreamingConfig",
    "StreamingPool",
    "StreamingResult",
    "StreamingTranscriber",
]
