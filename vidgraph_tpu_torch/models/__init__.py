from .text_embedder import HashedNGramEmbedder, make_embedder

__all__ = ["HashedNGramEmbedder", "make_embedder"]
