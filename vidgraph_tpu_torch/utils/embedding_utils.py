"""Embedding utilities (reference: src/utils/embedding_utils.py:7-38).

The reference's ``create_embeddings`` was an explicit random-vector
placeholder; here it produces real deterministic embeddings through the
device hash embedder.  ``cosine_similarity`` is kept for API parity.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


class EmbeddingUtils:
    def __init__(self, dim: int = 512, embedder=None) -> None:
        from ..models.text_embedder import HashedNGramEmbedder

        self.dim = dim
        self._embedder = embedder or HashedNGramEmbedder(dim=dim)

    def create_embeddings(self, texts: Sequence[str]) -> np.ndarray:
        return self._embedder.embed(list(texts))

    @staticmethod
    def cosine_similarity(vec1, vec2) -> float:
        a = np.asarray(vec1, np.float32)
        b = np.asarray(vec2, np.float32)
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        if denom == 0:
            return 0.0
        return float(a @ b / denom)
