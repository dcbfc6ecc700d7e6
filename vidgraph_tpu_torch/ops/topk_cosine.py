"""Cosine scoring with a count mask and top-k over a store of normalised rows.

Counterpart of ``vidgraph_tpu/ops/topk_cosine.py``.  The TPU kernel there,
``_score_kernel`` (``pallas_call`` in ``_pallas_scores``), with the mask
and the two-stage ``lax.top_k`` that ``_fused_cosine_topk_count`` and
``_masked_topk`` put around it, becomes the CUDA C++ kernels of
``csrc/topk_cosine.cu``:

* ``cosine_score_tile`` normalises the queries (``q * rsqrt(sum q^2 +
  1e-12)``), scores a tile of 256 store rows per block, writes -1e30 for
  rows at or past ``count`` without reading them, and then either writes
  the dense scores or the tile's top-k partials;
* ``cosine_topk_merge`` merges the partials into ``(values [B,k] f32,
  indices [B,k] int32)``, score descending, ties to the lower row index
  as ``lax.top_k`` breaks them.

What bounds it on the H100 is the store read: 200,000 x 512 float32 rows
are 410 MB a call, so the kernel reads each row once for the whole query
batch and never writes the [B,N] scores when it only needs the top-k.

Dispatch: a tensor on the CPU takes the plain version (``cosine_scores_ref``
/ ``cosine_topk_ref``: a float32 ``torch.matmul``, the mask, a stable sort);
a CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches and ``REF_CALLS`` the wrapper's calls of the plain version, so a
run can show which one served it.

Limits of the kernel, checked before each launch: float32, contiguous,
``d`` a multiple of 4 and at most 2048, ``k <= 64`` (the serving path asks
for ``max(top_k_chunks, rerank_pool)``, 3 to 5 in the shipped configs).
Query batches beyond what shared memory holds are split into launches.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import _build

NEG = -1e30
NO_INDEX = 0x7FFFFFFF          # a partial slot with no row (csrc kNoIndex)
K_MAX = 64
_MAX_QUERIES_PER_LAUNCH = 32
_SMEM_BYTES = 232_448          # shared memory a block may opt into on sm_90

# launches of cosine_score_tile by mode, and of cosine_topk_merge
LAUNCHES: Dict[str, int] = {"score_topk": 0, "score_dense": 0, "merge": 0}
REF_CALLS = 0


def reset_counts() -> None:
    global REF_CALLS
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    REF_CALLS = 0


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


# ---------------------------------------------------------------- plain
def cosine_scores_ref(query: torch.Tensor, store: torch.Tensor,
                      count: Optional[int] = None) -> torch.Tensor:
    """Plain version: [B,N] float32 scores, rows >= count set to -1e30."""
    scores = l2_normalize(query) @ store.float().T
    if count is not None and count < store.shape[0]:
        scores[:, max(count, 0):] = NEG
    return scores


def cosine_topk_ref(query: torch.Tensor, store: torch.Tensor, k: int,
                    count: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the top-k: a stable descending sort, so equal
    scores keep ascending row order."""
    scores = cosine_scores_ref(query, store, count)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)


# ---------------------------------------------------------------- public
def cosine_scores(query: torch.Tensor, store: torch.Tensor,
                  count: Optional[int] = None) -> torch.Tensor:
    """Cosine scores of ``query [B,d]`` against pre-normalised
    ``store [N,d]``; rows at or past ``count`` score -1e30."""
    global REF_CALLS
    b, n = _shapes(query, store)
    if n == 0 or b == 0:
        return torch.zeros((b, n), dtype=torch.float32, device=query.device)
    if query.device.type == "cpu":
        REF_CALLS += 1
        return cosine_scores_ref(query, store, count)
    return _cuda_scores(query, store, _count(count, n))


def cosine_topk(query: torch.Tensor, store: torch.Tensor, k: int,
                count: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k cosine matches: ``(values [B,k] f32, indices [B,k] int32)``.

    Masked rows score -1e30; past the end of the store the result is
    padded with -1e30 at index 0, as the JAX package pads it."""
    global REF_CALLS
    if not 0 < k <= K_MAX:
        raise ValueError(f"k={k} outside 1..{K_MAX}, the kernel's bound")
    b, n = _shapes(query, store)
    if n == 0:
        return (torch.full((b, k), NEG, dtype=torch.float32,
                           device=query.device),
                torch.zeros((b, k), dtype=torch.int32, device=query.device))
    kk = min(k, n)
    if b == 0:
        vals = torch.zeros((0, kk), dtype=torch.float32, device=query.device)
        idx = torch.zeros((0, kk), dtype=torch.int32, device=query.device)
    elif query.device.type == "cpu":
        REF_CALLS += 1
        vals, idx = cosine_topk_ref(query, store, kk, count)
    else:
        vals, idx = _cuda_topk(query, store, kk, _count(count, n))
    if kk < k:
        vals = torch.cat([vals, torch.full((b, k - kk), NEG,
                                           dtype=vals.dtype,
                                           device=vals.device)], dim=1)
        idx = torch.cat([idx, torch.zeros((b, k - kk), dtype=idx.dtype,
                                          device=idx.device)], dim=1)
    return vals, idx


# ---------------------------------------------------------------- kernel
def _shapes(query: torch.Tensor, store: torch.Tensor) -> Tuple[int, int]:
    if query.dim() != 2 or store.dim() != 2 or \
            query.shape[1] != store.shape[1]:
        raise ValueError(f"query {tuple(query.shape)} and store "
                         f"{tuple(store.shape)} must be [B,d] and [N,d]")
    if query.device != store.device:
        raise ValueError(f"query on {query.device}, store on {store.device}")
    if query.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no cosine kernel for device {query.device}")
    return query.shape[0], store.shape[0]


def _count(count: Optional[int], n: int) -> int:
    return n if count is None else max(0, min(int(count), n))


def _check_kernel_inputs(query: torch.Tensor, store: torch.Tensor) -> int:
    """Raise on what the kernel does not take; return queries per launch."""
    d = query.shape[1]
    for name, t in (("query", query), ("store", store)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    max_dim = _build.library().cosine_max_dim()
    if d % 4 or d > max_dim:
        raise ValueError(f"d={d}: the kernel takes multiples of 4 up to "
                         f"{max_dim}")
    tile = _build.library().cosine_tile_rows()
    per_launch = min(_MAX_QUERIES_PER_LAUNCH,
                     _SMEM_BYTES // (4 * (d + tile)))
    n_tiles = -(-store.shape[0] // tile)
    if n_tiles * 4 > _SMEM_BYTES:
        raise ValueError(f"{store.shape[0]} rows exceed the merge kernel's "
                         f"{_SMEM_BYTES // 4 * tile} row bound")
    return per_launch


def _cuda_scores(query: torch.Tensor, store: torch.Tensor,
                 count: int) -> torch.Tensor:
    per_launch = _check_kernel_inputs(query, store)
    lib = _build.library()
    b, n = query.shape[0], store.shape[0]
    d = query.shape[1]
    out = torch.empty((b, n), dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        for s in range(0, b, per_launch):
            qc = query[s:s + per_launch]
            _build.check(lib.cosine_score_tile_launch(
                qc.data_ptr(), store.data_ptr(), qc.shape[0], n, d, count,
                0, out[s].data_ptr(), None, None, stream),
                "cosine_score_tile")
            LAUNCHES["score_dense"] += 1
    return out


def _cuda_topk(query: torch.Tensor, store: torch.Tensor, k: int,
               count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return topk_merge(*topk_partials(query, store, k, count), k)


# The two stages of the kernel path of ``cosine_topk``, on CUDA tensors,
# with their plain versions; exposed so that each kernel can be checked
# and timed on its own.
def topk_partials(query: torch.Tensor, store: torch.Tensor, k: int,
                  count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cosine_score_tile`` in top-k mode: each tile's top k as
    ``(part_vals [B,n_tiles,k] f32, part_idx [B,n_tiles,k] int32)``."""
    per_launch = _check_kernel_inputs(query, store)
    lib = _build.library()
    b, n = query.shape[0], store.shape[0]
    d = query.shape[1]
    n_tiles = -(-n // lib.cosine_tile_rows())
    dev = query.device
    part_vals = torch.empty((b, n_tiles, k), dtype=torch.float32, device=dev)
    part_idx = torch.empty((b, n_tiles, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for s in range(0, b, per_launch):
            qc = query[s:s + per_launch]
            _build.check(lib.cosine_score_tile_launch(
                qc.data_ptr(), store.data_ptr(), qc.shape[0], n, d, count, k,
                None, part_vals[s].data_ptr(), part_idx[s].data_ptr(),
                stream), "cosine_score_tile")
            LAUNCHES["score_topk"] += 1
    return part_vals, part_idx


def topk_merge(part_vals: torch.Tensor, part_idx: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cosine_topk_merge``: the partials' top k, ``(values [B,k] f32,
    indices [B,k] int32)``."""
    b, n_tiles = part_vals.shape[:2]
    dev = part_vals.device
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.check(_build.library().cosine_topk_merge_launch(
            part_vals.data_ptr(), part_idx.data_ptr(), b, n_tiles, k,
            vals.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "cosine_topk_merge")
        LAUNCHES["merge"] += 1
    return vals, idx


def topk_partials_ref(query: torch.Tensor, store: torch.Tensor, k: int,
                      count: int, tile: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``topk_partials`` for tiles of ``tile`` rows: rows
    past the store score -inf at index ``NO_INDEX``, as the kernel writes
    them."""
    scores = cosine_scores_ref(query, store, count)
    b, n = scores.shape
    n_tiles = -(-n // tile)
    padded = torch.full((b, n_tiles * tile), float("-inf"),
                        device=scores.device)
    padded[:, :n] = scores
    vals, idx = torch.sort(padded.view(b, n_tiles, tile), dim=2,
                           descending=True, stable=True)
    vals, idx = vals[:, :, :k].contiguous(), idx[:, :, :k].to(torch.int32)
    idx += torch.arange(0, n_tiles * tile, tile, dtype=torch.int32,
                        device=idx.device).view(1, n_tiles, 1)
    idx[vals == float("-inf")] = NO_INDEX
    return vals, idx


def topk_merge_ref(part_vals: torch.Tensor, part_idx: torch.Tensor,
                   k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``topk_merge``.  The partials run tile by tile in
    ascending rows, so a stable sort keeps ties in ascending row order."""
    b = part_vals.shape[0]
    vals, order = torch.sort(part_vals.reshape(b, -1), dim=1,
                             descending=True, stable=True)
    idx = part_idx.reshape(b, -1).gather(1, order[:, :k])
    return vals[:, :k].contiguous(), idx
