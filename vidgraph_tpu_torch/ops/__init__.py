from .topk_cosine import cosine_scores, cosine_topk, l2_normalize

__all__ = ["cosine_scores", "cosine_topk", "l2_normalize"]
