"""Serving-path mesh plumbing: one switch that turns multi-device on.

Counterpart of ``vidgraph_tpu/parallel/serving.py``: a process-wide
``DeviceMesh`` that the product code paths consult.

* ``make_embedding_store(dim, ...)`` — every embedding memory of the
  serving path (graph-store chunk vectors, stream memories, the HTTP
  memory server) comes from here: with an active mesh a row-sharded
  ``ShardedEmbeddingStore`` (global top-k over the ranks).
* ``shard_captioner_params`` / ``shard_vit_params`` — the model clients
  pass their weights through these, so that captioner and ViT inference
  run tensor-parallel over the mesh "model" axis (the trainer's
  shardings, ``models/train.py::captioner_shardings`` and
  ``models/vit.py::param_shardings``).
* ``serving_mesh()`` — the active mesh or None; ``maybe_mesh()`` enters
  it.

Request-driven serving (the CLI's ``stream`` and ``serve``) at a world of
more than one rank runs under a rank-0 leader that broadcasts each engine
step and request (``parallel/leader.py``), so that every rank's searches
and decodes pair up.

Policy (``mesh.enabled`` in the YAML config tree), as in the JAX package,
read for SPMD, where a process sees one device and the world is the ranks
of the default process group:

* ``"auto"`` (default) — a mesh iff the world has more than one rank: a
  process group initialised so, or a launcher's ``WORLD_SIZE``
  (``torchrun --nproc-per-node N``; the group is then initialised here);
* ``true`` — a mesh always: a world of one on the port's device when no
  group is initialised (the JAX package's "on even on one device");
* ``false`` — no mesh.

``configure()`` is called where ``PipelineConfig`` is loaded; the mesh is
built on first use (loading a config starts no process group).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, Optional

from ..core.logger import get_logger

logger = get_logger("serving")

_lock = threading.Lock()
_policy: Dict[str, Any] = {"enabled": "auto", "model_axis": 1}
_mesh: Any = None
_mesh_built = False


def configure(mesh_config: Any = None, *, enabled: Any = None,
              model_axis: Optional[int] = None) -> None:
    """Record the serving-mesh policy (lazy; builds nothing)."""
    global _mesh_built, _mesh
    with _lock:
        if mesh_config is not None:
            _policy["enabled"] = getattr(mesh_config, "enabled", "auto")
            _policy["model_axis"] = getattr(mesh_config, "model_axis", 1)
        if enabled is not None:
            _policy["enabled"] = enabled
        if model_axis is not None:
            _policy["model_axis"] = model_axis
        _mesh_built = False  # policy change invalidates the cached mesh
        _mesh = None


def serving_mesh():
    """The process-wide serving mesh, or None (single-device serving)."""
    global _mesh, _mesh_built
    with _lock:
        if _mesh_built:
            return _mesh
        enabled = _policy["enabled"]
        if enabled in (False, "false", "off", 0):
            _mesh, _mesh_built = None, True
            return None
        from .mesh import build_mesh, world_size

        if enabled in ("auto", None) and world_size() < 2:
            _mesh, _mesh_built = None, True
            return None
        _mesh = build_mesh(model_axis=int(_policy["model_axis"]))
        _mesh_built = True
        logger.info(
            "serving mesh active: %d ranks, axes %s (embedding search "
            "row-sharded over 'data'; captioner/ViT inference tensor-"
            "sharded over 'model')", _mesh.size(),
            dict(zip(_mesh.mesh_dim_names, _mesh.shape)))
        return _mesh


def make_embedding_store(dim: int, capacity: int = 1024, **kw):
    """EmbeddingStore on one device; ShardedEmbeddingStore on a mesh."""
    mesh = serving_mesh()
    if mesh is None:
        from ..memory.embedding_store import EmbeddingStore

        return EmbeddingStore(dim=dim, capacity=capacity, **kw)
    from .sharded_search import ShardedEmbeddingStore

    return ShardedEmbeddingStore(mesh, dim=dim, capacity=capacity, **kw)


def shard_captioner_params(params: Dict, mesh=None, *, heads: int) -> Dict:
    """This rank's slices of a captioner tree of ``heads`` attention heads
    under the trainer's tensor-parallel specs
    (``models/train.py::captioner_shardings``): qkv/fc1 column-split,
    attn_o/fc2 row-split over "model"; embeddings and head replicated.
    The slices of q, k and v are whole heads, hence ``heads``."""
    mesh = mesh or serving_mesh()
    if mesh is None:
        return params
    from ..models.train import shard_captioner

    return shard_captioner(params, mesh, heads)


def shard_vit_params(tower, mesh=None):
    """The tower with this rank's slices of its tensor-parallel layers
    (``models/vit.py::param_shardings``), in place."""
    mesh = mesh or serving_mesh()
    if mesh is None:
        return tower
    from ..models.vit import shard_tower

    return shard_tower(tower, mesh)


@contextlib.contextmanager
def maybe_mesh(mesh=None) -> Iterator[Any]:
    """``with maybe_mesh():`` — enters the serving mesh when active."""
    from .mesh import use_mesh

    mesh = mesh if mesh is not None else serving_mesh()
    if mesh is None:
        yield None
        return
    with use_mesh(mesh):
        yield mesh

