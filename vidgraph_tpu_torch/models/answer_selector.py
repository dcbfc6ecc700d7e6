"""Trained answer selection for the fully-on-device pipeline.

Counterpart of ``vidgraph_tpu/models/answer_selector.py``: answering as
selection.  A byte-level cross-encoder (the reranker trunk,
``models/reranker.py``) scores every candidate context sentence against
the question in one batched call, and the answer is assembled extractively
from the top-scored sentences with the teacher's MMR + neighbour-completion
decoding (``services.llm_client.assemble_answer``).

Weights come from the JAX package's ``scripts/train_answer_selector.py``
as an npz with a ``.json`` sidecar whose ``selector_cfg`` records the
trained architecture.  Scoring is ``reranker.score_tokens``, with its
deviations from JAX's static shapes (no batch bucket, no all-pad columns).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..core.logger import get_logger
from ..core.platform import device as default_device
from .reranker import (RerankerConfig, batch_encode_pairs,
                       init_reranker_params, score_tokens)

logger = get_logger("answer_selector")


class AnswerSelector:
    """(question, candidate sentences) -> relevance scores + extractive
    answer assembly, one batched call a question on ``device`` (default:
    ``core.platform.device()``).

    ``mode``: ``blend`` (default) makes the model's scores the semantic
    channel of the lexical teacher's scorer, so they break near-ties and
    never overrule exact term matches; ``pure`` lets them drive selection
    alone."""

    def __init__(self, cfg: Optional[RerankerConfig] = None, seed: int = 0,
                 checkpoint_path: str = "", mode: str = "blend",
                 device: Optional[torch.device] = None) -> None:
        self.mode = mode
        self.cfg = cfg or RerankerConfig()
        self.device = device or default_device()
        if checkpoint_path:
            # the sidecar records the trained architecture
            meta = Path(checkpoint_path).with_suffix(".json")
            if cfg is None and meta.exists():
                try:
                    sc = json.loads(meta.read_text()).get("selector_cfg")
                    if sc:
                        self.cfg = RerankerConfig(**sc)
                except (ValueError, OSError, TypeError):
                    pass
        self.params = init_reranker_params(self.cfg, seed, self.device)
        if checkpoint_path:
            from .checkpoint import load_params
            self.params = load_params(self.params, checkpoint_path)
            logger.info("Loaded answer-selector weights from %s",
                        checkpoint_path)

    def score(self, question: str, cands: List[str]) -> np.ndarray:
        if not cands:
            return np.zeros((0,), np.float32)
        return score_tokens(self.params, self.cfg,
                            batch_encode_pairs(question, cands, self.cfg),
                            self.device)

    def answer(self, question: str, context: str,
               max_sentences: int = 4, max_chars: int = 600) -> str:
        """Model-scored extractive answer (``self.mode``):

        * ``blend`` — the model is the semantic channel of the teacher's
          scorer (``teacher_answer_scores(sem_fn=...)``): lexical prior
          decides, model z-scores break near-ties.
        * ``pure`` — the model's scores drive selection alone; the
          teacher's MMR/neighbor assembly decodes the sentence set.
        """
        from ..services.llm_client import (_idf_weights, _stem, _words,
                                           answer_candidates,
                                           assemble_answer,
                                           teacher_answer_scores)

        if self.mode == "blend":
            scored = teacher_answer_scores(
                question, context, sem_fn=lambda q, c: self.score(q, c))
            if scored is None:
                return "I don't know."
            cand, toks, idf, scores = scored
            return assemble_answer(cand, toks, idf, scores,
                                   max_sentences=max_sentences,
                                   max_chars=max_chars)

        cand = answer_candidates(context)
        if not cand:
            return "I don't know."
        toks = [[_stem(w.lower()) for w in _words(s)] for s in cand]
        idf = _idf_weights(toks)
        s = self.score(question, cand).astype(np.float64)
        # model logits are scale-free: shift to a positive range so the
        # assembly's relative floor (0.35 x top) applies and the
        # "no answer" zero-check never false-fires on a negative logit
        s = s - s.min() + 1e-3
        return assemble_answer(cand, toks, idf, [float(x) for x in s],
                               max_sentences=max_sentences,
                               max_chars=max_chars, abs_floor=0.0)
