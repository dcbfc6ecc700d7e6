"""Multi-device embedding-memory search: the store's rows sharded over the
mesh "data" axis, each rank scores its shard, a global top-k over the ranks.

Counterpart of ``vidgraph_tpu/parallel/sharded_search.py``.
``ShardedEmbeddingStore`` is a drop-in subclass of
``memory.embedding_store.EmbeddingStore``: the host side (id overwrite,
growth, persistence) is inherited, only the device mirror and the search
differ.  It is what ``parallel.serving.make_embedding_store`` hands the
serving path whenever a mesh is active.

Where XLA inserted the collectives, each rank here runs them itself (every
rank of the mesh calls ``search`` with the same queries, as SPMD code
does).  Data rank ``r`` of ``D`` mirrors rows ``[r N/D, (r+1) N/D)`` of
``_padded_host()`` on its device and:

1. runs the cosine top-k kernel (``ops/topk_cosine.py``) on its shard,
   with the count clipped to the shard (``clamp(count - offset, 0,
   N/D)``), and adds the shard's offset to the row indices.  A slot that
   holds no live row (a shard wholly past ``count``, or ``k`` above the
   shard's live rows) carries -1e30 and no row index;
2. all-gathers the ``[B, k]`` values and indices over "data";
3. takes the top-k of the ``D k`` candidates by a stable descending sort.
   The candidates are in rank order and each rank's in ascending row order
   among equal scores, so ties resolve to the lower global row, as
   ``lax.top_k`` resolves them.

The ranks along "model" hold the same shard and compute the same answer.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..memory.embedding_store import EmbeddingStore, device_mirror
from ..ops.topk_cosine import NEG, NO_INDEX, cosine_scores, cosine_topk
from . import comm
from .mesh import DATA_AXIS, axis_group, axis_rank, axis_size, data_sharded


class ShardedEmbeddingStore(EmbeddingStore):
    """Drop-in ``EmbeddingStore`` whose device mirror is row-sharded over
    the mesh "data" axis.  Host-side semantics (id overwrite, growth,
    persistence) are inherited unchanged."""

    def __init__(self, mesh, dim: int, capacity: int = 8192, **kw) -> None:
        self.mesh = mesh
        self._data_size = axis_size(mesh, DATA_AXIS)
        self._data_rank = axis_rank(mesh, DATA_AXIS)
        self._group = axis_group(mesh, DATA_AXIS)
        self.placements = data_sharded(mesh)
        super().__init__(dim=dim, capacity=capacity, **kw)

    # -- device paths ---------------------------------------------------------
    def _padded_host(self) -> np.ndarray:
        """Host buffer padded to a row count divisible by the data axis
        (capacity is a power of two, so this is a no-op for power-of-two
        meshes; odd device counts pad a few zero rows)."""
        cap = self._host.shape[0]
        rem = cap % self._data_size
        if rem == 0:
            return self._host
        pad = self._data_size - rem
        return np.concatenate(
            [self._host, np.zeros((pad, self.dim), np.float32)])

    def shard_rows(self) -> int:
        """Rows of the store each rank mirrors."""
        return self._padded_host().shape[0] // self._data_size

    def _device_store(self) -> torch.Tensor:
        """This rank's shard of the padded mirror."""
        if self._mirror_dirty or self._mirror is None:
            rows = self.shard_rows()
            lo = self._data_rank * rows
            shard = np.ascontiguousarray(self._padded_host()[lo:lo + rows])
            self._mirror = None          # the old mirror's memory first
            self._mirror = device_mirror(shard, self.dtype, self._device)
            self._mirror_dirty = False
        return self._mirror

    def _device_topk(self, q: torch.Tensor, kk: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        with self._lock:
            shard = self._device_store()
            count = self._count
        rows = shard.shape[0]
        offset = self._data_rank * rows
        live = min(max(count - offset, 0), rows)
        b = q.shape[0]
        vals = torch.full((b, kk), NEG, dtype=torch.float32, device=q.device)
        idx = torch.full((b, kk), NO_INDEX, dtype=torch.int64,
                         device=q.device)
        if live > 0:
            k_local = min(kk, live)
            v, i = cosine_topk(q, shard, k_local, count=live)
            vals[:, :k_local] = v
            idx[:, :k_local] = i.long() + offset
        if self._group is not None:
            vals = torch.cat(comm.all_gather(vals, self._group), dim=1)
            idx = torch.cat(comm.all_gather(idx, self._group), dim=1)
            vals, order = torch.sort(vals, dim=1, descending=True,
                                     stable=True)
            vals = vals[:, :kk]
            idx = torch.gather(idx, 1, order[:, :kk])
        return vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()

    def _device_scores(self, q: torch.Tensor) -> np.ndarray:
        with self._lock:
            shard = self._device_store()
            count = self._count
        scores = cosine_scores(q, shard)
        if self._group is not None:
            scores = torch.cat(comm.all_gather(scores, self._group), dim=1)
        return scores[:, :count].cpu().numpy()
