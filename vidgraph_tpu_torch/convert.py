"""Carry state across from the JAX package (``vidgraph_tpu``).

The query path has no trained weights: the embedder's projection is drawn
from ``np.random.default_rng(seed)`` in both packages, so the same seed
gives the same embedder.  What crosses is

* an embedding memory: ``vidgraph_tpu``'s ``EmbeddingStore.state_dict()``
  (ids and numpy vectors) becomes the port's store with
  ``store_from_jax_state``;
* a projection matrix, with ``projection_from_numpy``;
* a graph: both packages read and write the same per-UUID JSON snapshot
  under ``graph_store.persist_dir`` and the same export format v1.0, so a
  graph built by either is opened by the other as it is.

Nothing here imports the JAX package: it takes the numpy state it writes.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .memory.embedding_store import EmbeddingStore
from .models.text_embedder import HashedNGramEmbedder


def store_from_jax_state(state_dict: Dict,
                         device: Optional[torch.device] = None
                         ) -> EmbeddingStore:
    """The port's store holding the rows of a JAX ``state_dict()``."""
    return EmbeddingStore.from_state(state_dict, device=device)


def projection_from_numpy(proj: np.ndarray,
                          device: Optional[torch.device] = None
                          ) -> HashedNGramEmbedder:
    """A hashed n-gram embedder that projects with ``proj
    [n_buckets, dim]`` (float32) instead of its seeded draw."""
    proj = np.asarray(proj, np.float32)
    emb = HashedNGramEmbedder(dim=proj.shape[1], n_buckets=proj.shape[0],
                              device=device)
    emb.set_projection(proj)
    return emb
