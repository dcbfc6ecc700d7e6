"""Trained cross-encoder reranker (``backend.reranker: trained``).

Counterpart of ``vidgraph_tpu/models/reranker.py``: a byte-level
bidirectional transformer over the concatenated ``query [SEP] document``
sequence, mean-pooled and scored by a linear head, so that query and
document bytes attend to each other (the signal an embedding cosine cannot
add).  The blocks are the captioner's under the per-example padding mask
(``captioner._block(mask=)``: the masked plain attention, as the JAX
package runs it through XLA; no kernel of its own).

Trained in the JAX package by ``scripts/train_reranker.py`` as a residual
on the retrieval embedder's cosine prior; its npz and ``cosine_lambda``
sidecar load here as they are.  Deviations, neither visible beyond
float32 rounding: JAX pads each batch of pairs to a power of two of at
least 8 rows and every pair to ``max_len`` (512) bytes, static shapes that
bound its compile count; rows are independent under the mask, so the port
scores the batch as it comes, without its trailing all-pad columns
(``text_embedder.trim_padding``: a bench retrieval's pairs hold ~200
bytes).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..core.logger import get_logger
from ..core.platform import device as default_device
from . import tokenizer


@dataclasses.dataclass(frozen=True)
class RerankerConfig:
    width: int = 256
    layers: int = 4
    heads: int = 4
    max_len: int = 512
    query_budget: int = 120     # query bytes kept in the pair encoding
    dtype: Any = torch.float32

    @classmethod
    def tiny(cls) -> "RerankerConfig":
        return cls(width=32, layers=2, heads=2, max_len=96, query_budget=24)

    def captioner_cfg(self):
        """The underlying encoder blocks reuse the captioner param tree."""
        from .captioner import CaptionerConfig
        return CaptionerConfig(width=self.width, layers=self.layers,
                               heads=self.heads, vision_dim=self.width,
                               num_vision_tokens=1, max_len=self.max_len,
                               dtype=self.dtype)


def init_reranker_params(cfg: RerankerConfig, seed: int = 0,
                         device: Optional[torch.device] = None):
    """The JAX package's ``init_reranker_params(cfg, seed)``: the
    captioner tree ``init_params(cfg.captioner_cfg(), seed)`` without its
    decoder head and vision projection, ``score_w`` [width, 1] from
    ``np.random.default_rng(seed + 7)``, and a zero ``score_b`` [1]."""
    from .captioner import init_params

    enc = init_params(cfg.captioner_cfg(), seed, device=device)
    for key in ("head_w", "vis_proj_w", "vis_proj_b"):
        enc.pop(key, None)
    rng = np.random.default_rng(seed + 7)
    score_w = rng.normal(0, 1 / np.sqrt(cfg.width),
                         size=(cfg.width, 1)).astype(np.float32)
    return {"enc": enc, "score_w": torch.from_numpy(score_w).to(device),
            "score_b": torch.zeros((1,), dtype=torch.float32, device=device)}


def encode_pair(query: str, doc: str, cfg: RerankerConfig) -> List[int]:
    """[BOS] query-bytes [EOS] doc-bytes, truncated to ``max_len``."""
    q = tokenizer.encode(query, add_bos=False, add_eos=False)
    q = q[:cfg.query_budget]
    budget = cfg.max_len - len(q) - 2
    d = tokenizer.encode(doc, add_bos=False, add_eos=False)[:budget]
    return [tokenizer.BOS_ID] + q + [tokenizer.EOS_ID] + d


def batch_encode_pairs(query: str, docs: Sequence[str],
                       cfg: RerankerConfig) -> np.ndarray:
    toks = np.full((len(docs), cfg.max_len), tokenizer.PAD_ID, np.int32)
    for i, doc in enumerate(docs):
        ids = encode_pair(query, doc, cfg)
        toks[i, :len(ids)] = ids
    return toks


def reranker_scores(params, cfg: RerankerConfig,
                    tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] -> relevance scores [B] float32 (higher = more
    relevant)."""
    from .captioner import encode_pooled

    pooled = encode_pooled(params["enc"], cfg.captioner_cfg(), tokens)
    return (pooled @ params["score_w"] + params["score_b"])[:, 0]


@torch.no_grad()
def score_tokens(params, cfg: RerankerConfig, toks: np.ndarray,
                 device: torch.device) -> np.ndarray:
    """``reranker_scores`` of host tokens [B, T] on ``device``, as numpy;
    the trailing all-pad columns are left out (``trim_padding``)."""
    from .text_embedder import trim_padding

    tokens = torch.from_numpy(trim_padding(toks)).to(device).long()
    return reranker_scores(params, cfg, tokens).cpu().numpy()


class CrossEncoderReranker:
    """Host-facing wrapper: (query, documents) -> scores, one batched call
    on ``device`` (default: ``core.platform.device()``).

    Trained as a residual on the retrieval-embedder cosine prior (training
    logits = cross_score + λ·cosine): serve with the same ``embed_client``
    to reproduce the prior; λ comes from the checkpoint's ``.json``
    sidecar (``cosine_lambda``)."""

    def __init__(self, cfg: RerankerConfig = None, seed: int = 0,
                 checkpoint_path: str = "", embed_client=None,
                 device: Optional[torch.device] = None) -> None:
        self.cfg = cfg or RerankerConfig()
        self.device = device or default_device()
        self.params = init_reranker_params(self.cfg, seed, self.device)
        self.cosine_lambda = 0.0
        self._embed = embed_client
        if checkpoint_path:
            from .checkpoint import load_params
            self.params = load_params(self.params, checkpoint_path)
            meta = Path(checkpoint_path).with_suffix(".json")
            if meta.exists():
                try:
                    self.cosine_lambda = float(json.loads(
                        meta.read_text()).get("cosine_lambda", 0.0))
                except (ValueError, OSError):
                    pass
        if self.cosine_lambda > 0 and self._embed is None:
            # a residual checkpoint served without its cosine prior
            # degrades to near-random ordering
            get_logger("reranker").warning(
                "Checkpoint %s was trained with cosine_lambda=%.3f but no "
                "embed_client was provided — the cosine prior term is "
                "dropped and ranking quality will degrade; pass the same "
                "embedder used at training time", checkpoint_path,
                self.cosine_lambda)

    def score(self, query: str, docs: Sequence[str]) -> np.ndarray:
        if not docs:
            return np.zeros((0,), np.float32)
        s = score_tokens(self.params, self.cfg,
                         batch_encode_pairs(query, docs, self.cfg),
                         self.device)
        if self.cosine_lambda and self._embed is not None:
            vecs = self._embed.embed([query] + list(docs))
            s = s + self.cosine_lambda * (vecs[1:] @ vecs[0])
        return s
