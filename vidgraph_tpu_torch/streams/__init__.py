"""Serving-side scheduling and the live multi-stream runtime of the port:
the JAX package's exports (``streams/realtime.py``, ``streams/ingest.py``,
verbatim copies) and the continuous batcher of the chat LM."""
from .ingest import LiveKGIngestor, video_frame_source
from .realtime import FrameRing, RealtimeEngine, StreamSpec, simulate
from .scheduler import ContinuousBatcher

__all__ = ["FrameRing", "RealtimeEngine", "StreamSpec", "simulate",
           "LiveKGIngestor", "video_frame_source", "ContinuousBatcher"]
