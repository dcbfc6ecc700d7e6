"""Serving-path embedding memory on one card.

Counterpart of ``vidgraph_tpu/parallel/serving.py::make_embedding_store``,
which returns a row-sharded store when a serving mesh is active.  The port
serves from one card; the multi-card store is ROADMAP slice 9.
"""
from ..memory.embedding_store import EmbeddingStore


def make_embedding_store(dim: int, capacity: int = 1024,
                         **kw) -> EmbeddingStore:
    """EmbeddingStore on ``core.platform.device()``."""
    return EmbeddingStore(dim=dim, capacity=capacity, **kw)
