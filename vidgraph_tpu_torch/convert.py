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
  graph built by either is opened by the other as it is;
* captioner (chat LM) parameters, with ``captioner_params_from_jax``, or
  as a checkpoint in the JAX npz format (``models/checkpoint.py``);
* the trained encoders' parameters: the text embedder's (``{"enc": <captioner
  tree>, "out_w"}``) with ``encoder_params_from_jax`` and the cross-encoder's
  or the answer selector's (``{"enc", "score_w", "score_b"}``) with
  ``reranker_params_from_jax``, or as their npz checkpoints;
* the vision tower's Flax tree, with ``vit_params_from_jax``, or inside
  the VLM checkpoint ``{"vit": <flax tree>, "cap": <captioner tree>}``
  that ``services/vlm_client.py::TPUVLMClient`` reads;
* trained parameters back to numpy, with ``to_numpy_tree``.

Nothing here imports the JAX package: it takes the numpy state it writes.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .memory.embedding_store import EmbeddingStore
from .models.checkpoint import from_numpy, to_numpy
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


def captioner_params_from_jax(tree: Any,
                              device: Optional[torch.device] = None) -> Any:
    """The port's captioner parameters from a JAX captioner tree (``init_
    params`` layout) whose leaves are numpy arrays: float32, or bfloat16
    as ``ml_dtypes.bfloat16`` or as uint16 bit patterns.  A leaf with
    ``q`` and ``s`` (the JAX package's ``Q8`` with numpy children) becomes
    the port's ``Q8``.  Values and dtypes are kept bit for bit."""
    if hasattr(tree, "q") and hasattr(tree, "s"):
        from .models.quant8 import Q8

        return Q8(captioner_params_from_jax(tree.q, device),
                  captioner_params_from_jax(tree.s, device))
    if isinstance(tree, Mapping):
        return {k: captioner_params_from_jax(v, device)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [captioner_params_from_jax(v, device) for v in tree]
    arr = np.asarray(tree)
    bf16 = arr.dtype == np.uint16 or arr.dtype.name == "bfloat16"
    if bf16:
        arr = arr.view(np.uint16)
    return from_numpy(arr, bf16).to(device or torch.device("cpu"))


def encoder_params_from_jax(tree: Any,
                            device: Optional[torch.device] = None) -> Dict:
    """The port's ``TransformerTextEmbedder`` parameters from the JAX
    package's ``init_encoder_params`` tree (numpy leaves): ``{"enc":
    <captioner tree without head_w and vis_proj>, "out_w": [width, dim]}``,
    bit for bit."""
    if set(tree) != {"enc", "out_w"}:
        raise ValueError(f"not an encoder tree: keys {sorted(tree)}")
    return captioner_params_from_jax(tree, device)


def reranker_params_from_jax(tree: Any,
                             device: Optional[torch.device] = None) -> Dict:
    """The port's cross-encoder (``CrossEncoderReranker``,
    ``AnswerSelector``) parameters from the JAX package's
    ``init_reranker_params`` tree (numpy leaves): ``{"enc", "score_w"
    [width, 1], "score_b" [1]}``, bit for bit."""
    if set(tree) != {"enc", "score_w", "score_b"}:
        raise ValueError(f"not a reranker tree: keys {sorted(tree)}")
    return captioner_params_from_jax(tree, device)


def vit_params_from_jax(tree: Any, device: Optional[torch.device] = None
                        ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the port's ``VisionTower`` from the JAX
    package's Flax tree ``{"params": {...}}`` with numpy leaves (Flax's
    [in, out] kernels are the port's as they are).  Values and dtypes are
    kept bit for bit: ``tower.load_state_dict(vit_params_from_jax(t))``."""
    from .models.vit import state_dict_from_tree

    return state_dict_from_tree(captioner_params_from_jax(tree, device))


def to_numpy_tree(tree: Any) -> Any:
    """The way back: a parameter tree of the port (nested dicts and lists
    of tensors) as numpy arrays for the JAX package, bfloat16 leaves as
    ``ml_dtypes.bfloat16`` where that package is installed and as uint16
    bit patterns otherwise."""
    if isinstance(tree, Mapping):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy_tree(v) for v in tree]
    bf16, arr = to_numpy(tree)
    if bf16:
        try:
            import ml_dtypes
        except ImportError:
            return arr
        return arr.view(ml_dtypes.bfloat16)
    return arr
