from .embedding_store import EmbeddingStore

__all__ = ["EmbeddingStore"]
