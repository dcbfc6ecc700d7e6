"""Cosine scoring with a count mask and top-k over a store of normalised rows.

Counterpart of ``vidgraph_tpu/ops/topk_cosine.py``.  The TPU kernel there,
``_score_kernel`` (``pallas_call`` in ``_pallas_scores``), with the mask
and the two-stage ``lax.top_k`` that ``_fused_cosine_topk_count`` and
``_masked_topk`` put around it, becomes the CUDA C++ kernels of
``csrc/topk_cosine.cu`` and ``csrc/topk_select.cu``:

* ``cosine_score_tile`` normalises the queries (``q * rsqrt(sum q^2 +
  1e-12)``) and streams the store once, one block per SM walking a segment
  of 256-row tiles through a ring of stages filled by TMA, with the scores
  register-tiled as an SGEMM (2 rows x the batch a thread).  Rows at or
  past ``count`` score -1e30 and are never read.  It writes either the
  dense scores or, for k up to ``LIST_K``, the top-k ``(values [B,k] f32,
  indices [B,k] int32)``, score descending, ties to the lower row index as
  ``lax.top_k`` breaks them: each block keeps its segment's sorted list,
  writes it to scratch, and the block that finishes last merges every
  list, so a search is one launch;
* ``cosine_select`` takes the top-k of the dense scores for k above
  ``LIST_K``: a threshold from each thread's best entry (or a radix
  select), the entries at or above it gathered, a bitonic sort of those.
  It is bit-equal to a stable descending sort's first k (``select_ref``,
  ``lax.top_k``'s order), as the JAX package leaves that top-k to
  ``lax.top_k`` outside the Pallas kernel.

The store is float32, bfloat16 or float16 (``STORE_TYPES``), read in its
own type and upcast to float32 in the kernel, as ``_score_kernel`` upcasts
its store tile; the queries are float32.  Any width ``d`` is taken: the
TMA copies need a row stride of a multiple of 16 bytes, so a store may be
a view of the first ``d`` columns of rows kept wider (``padded_width``;
``memory/embedding_store.py`` keeps its mirror so, and a search copies
nothing); any other row-major store is copied into such rows first.

What bounds it on the H100 is the store read: 200,000 x 512 float32 rows
are 410 MB a call (bfloat16 205 MB), so the kernel reads each row once for
the whole query batch, keeps the next slices in flight while it scores
this one, and never writes the [B,N] scores when it only needs the top-k.

Dispatch: a tensor on the CPU takes the plain version (``cosine_scores_ref``
/ ``cosine_topk_ref``: a float32 ``torch.matmul``, the mask, a stable sort);
a CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel
launches and ``REF_CALLS`` the wrapper's calls of the plain version, so a
run can show which one served it.

Query batches beyond what one launch takes (32 at d <= 512, fewer above,
``cosine_queries_per_launch``) are split into launches.  The top-k
launches of a stream count their blocks on one completion counter of the
library (``_counter_slot``), which each launch leaves at zero: launches
that may run at once must be on different streams.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build

NEG = -1e30
NO_INDEX = 0x7FFFFFFF          # a partial slot with no row (csrc kNoIndex)
LIST_K = 64                    # the longest per-segment list (csrc kMaxK)
# the store's element types, by the code the kernel takes
STORE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# dense scores one selection above LIST_K holds at once
SELECT_BYTES = 1 << 28

# launches of cosine_score_tile by mode, and of cosine_select
LAUNCHES: Dict[str, int] = {"score_topk": 0, "score_dense": 0, "select": 0}
REF_CALLS = 0


def reset_counts() -> None:
    global REF_CALLS
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    REF_CALLS = 0


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def padded_width(d: int, dtype: torch.dtype) -> int:
    """Columns a row of ``d`` values of ``dtype`` is kept in so that rows
    lie a multiple of 16 bytes apart, as the kernel's copies need."""
    per16 = 16 // dtype.itemsize
    return -(-d // per16) * per16


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
    return select_ref(cosine_scores_ref(query, store, count), k)


def select_ref(scores: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``select_topk``: the first k of each row's stable
    descending sort, ``(values [B,k] f32, indices [B,k] int32)``, in
    ``lax.top_k``'s order: IEEE total order (+0.0 above -0.0, which
    ``torch.sort`` takes as equal), so the sort is of each score's
    order-preserving int32 key."""
    bits = scores.float().contiguous().view(torch.int32)
    keys = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    idx = torch.sort(keys, dim=1, descending=True, stable=True)[1][:, :k]
    return scores.float().gather(1, idx).contiguous(), idx.to(torch.int32)


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
    padded with -1e30 at index 0, as the JAX package pads it.  ``k = 0``
    gives empty results, as ``lax.top_k`` does."""
    global REF_CALLS
    if k < 0:
        raise ValueError(f"k={k}: top-k takes k >= 0")
    b, n = _shapes(query, store)
    if n == 0:
        return (torch.full((b, k), NEG, dtype=torch.float32,
                           device=query.device),
                torch.zeros((b, k), dtype=torch.int32, device=query.device))
    kk = min(k, n)
    if b == 0 or kk == 0:
        vals = torch.zeros((b, kk), dtype=torch.float32, device=query.device)
        idx = torch.zeros((b, kk), dtype=torch.int32, device=query.device)
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


def aligned_store(store: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """``store`` as the kernel reads it, and the elements between its rows:
    row-major, rows a multiple of 16 bytes apart from a 16-byte aligned
    start.  A store that is not so is copied into zero-padded rows of
    ``padded_width`` columns, of which the view keeps the first ``d``."""
    if store.dtype not in STORE_TYPES:
        raise ValueError(f"store is {store.dtype}; the kernel takes "
                         "float32, bfloat16 or float16")
    n, d = store.shape
    if store.stride(1) != 1 and d > 1:
        raise ValueError("store must be row-major (unit column stride)")
    # a single row's stride is never used: any 16-byte multiple will do
    ld = store.stride(0) if n > 1 else padded_width(d, store.dtype)
    if (ld * store.element_size()) % 16 == 0 and ld >= d \
            and store.data_ptr() % 16 == 0:
        return store, ld
    rows = torch.zeros((n, padded_width(d, store.dtype)), dtype=store.dtype,
                       device=store.device)
    rows[:, :d] = store
    return rows[:, :d], rows.shape[1]


@functools.lru_cache(maxsize=1024)
def _queries_per_launch(d: int, k: int, store_type: int) -> int:
    return _build.library().cosine_queries_per_launch(d, k, store_type)


def _check_kernel_inputs(query: torch.Tensor, store: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, int, int]:
    """Raise on what the kernel does not take; return the store as it
    reads it, its row stride and the queries a launch takes."""
    if query.dtype != torch.float32:
        raise ValueError(f"query is {query.dtype}; the kernel takes float32")
    if not query.is_contiguous():
        raise ValueError("query must be contiguous")
    store, ld = aligned_store(store)
    d = query.shape[1]
    per_launch = _queries_per_launch(d, k, STORE_TYPES[store.dtype])
    if per_launch < 1:
        raise ValueError(f"d={d}: one query's row leaves no room for the "
                         "kernel's ring of stages")
    return store, ld, per_launch


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _tile_rows() -> int:
    return _build.library().cosine_tile_rows()


def segment_tiles(n: int, device: torch.device) -> int:
    """Tiles of ``cosine_tile_rows()`` rows that one block of the
    persistent grid scores: the store's tiles spread over the card's SMs.
    A segment is ``segment_tiles * cosine_tile_rows()`` rows and gets one
    top-k partial list."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    n_tiles = -(-n // _tile_rows())
    return -(-n_tiles // _sm_count(index))


def segment_rows(n: int, device: torch.device) -> int:
    """Store rows per top-k partial list (see ``segment_tiles``)."""
    return segment_tiles(n, device) * _tile_rows()


# the completion counter of top-k launches on a (device, stream)
_counter_slot = _build.CounterSlots("top-k launches", "cosine_counter_slots")


def _on(device: torch.device):
    """``device`` made current for a launch, where it is not already."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _stream(device: torch.device) -> int:
    """The current stream of ``device``, as the launches take it."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch(query: torch.Tensor, store: torch.Tensor, ld: int, count: int,
            k: int, tpb: int, stream: int, out=None, parts=(None, None),
            top=(None, None), slot: int = 0) -> None:
    """One ``cosine_score_tile`` launch over ``query`` (at most a launch's
    queries), ``tpb`` tiles a block, on ``stream``: the dense scores into
    ``out``, or the lists into ``parts`` and the top k into ``top``
    (pointers)."""
    n, d = store.shape
    _build.check(_build.library().cosine_score_tile_launch(
        query.data_ptr(), store.data_ptr(), STORE_TYPES[store.dtype], ld,
        query.shape[0], n, d, count, k, tpb, out, *parts, *top, slot,
        stream), "cosine_score_tile")


def _cuda_scores(query: torch.Tensor, store: torch.Tensor,
                 count: int) -> torch.Tensor:
    store, ld, per_launch = _check_kernel_inputs(query, store, 0)
    b, n = query.shape[0], store.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=query.device)
    tpb = segment_tiles(n, query.device)
    with _on(query.device):
        stream = _stream(query.device)
        for s in range(0, b, per_launch):
            _launch(query[s:s + per_launch], store, ld, count, 0, tpb,
                    stream, out=out[s].data_ptr())
            LAUNCHES["score_dense"] += 1
    return out


def _cuda_topk(query: torch.Tensor, store: torch.Tensor, k: int,
               count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's top-k of the first ``count`` rows; the rows past it
    score -1e30 and tie, so they follow in row order, as ``lax.top_k``
    puts them, and the kernel neither reads nor scores them."""
    live = min(k, count)
    if live == 0:
        vals = torch.empty((query.shape[0], 0), device=query.device)
        idx = torch.empty((query.shape[0], 0), dtype=torch.int32,
                          device=query.device)
    else:
        if count < store.shape[0]:
            store = store[:count]
        vals, idx = (topk_lists(query, store, live, count, lists=False)
                     if live <= LIST_K else _select(query, store, live))
    if live < k:
        b = query.shape[0]
        vals = torch.cat([vals, torch.full((b, k - live), NEG,
                                           device=vals.device)], dim=1)
        idx = torch.cat([idx, torch.arange(
            count, count + k - live, dtype=torch.int32,
            device=idx.device).expand(b, -1)], dim=1)
    return vals, idx


def _select(query: torch.Tensor, store: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Above the lists: the kernel's dense scores, then ``select_topk``,
    a block of queries at a time."""
    b, n = query.shape[0], store.shape[0]
    step = max(1, SELECT_BYTES // (4 * n))
    vals = torch.empty((b, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((b, k), dtype=torch.int32, device=query.device)
    for s in range(0, b, step):
        scores = _cuda_scores(query[s:s + step], store, n)
        _cuda_select(scores, k, vals[s:s + step], idx[s:s + step])
        del scores
    return vals, idx


def select_topk(scores: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cosine_select``: the top k of each row of float32 ``scores
    [B,n]``, ``(values [B,k] f32, indices [B,k] int32)``, score descending,
    ties to the lower column; 1 <= k <= n."""
    global REF_CALLS
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"scores {tuple(scores.shape)} {scores.dtype}: the "
                         "kernel takes float32 [B,n]")
    b, n = scores.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k}: a selection takes 1 <= k <= n={n}")
    if scores.device.type == "cpu":
        REF_CALLS += 1
        return select_ref(scores, k)
    vals = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((b, k), dtype=torch.int32, device=scores.device)
    if b:
        _cuda_select(scores.contiguous(), k, vals, idx)
    return vals, idx


def _cuda_select(scores: torch.Tensor, k: int, vals: torch.Tensor,
                 idx: torch.Tensor) -> None:
    """One ``cosine_select`` launch over contiguous ``scores`` into the
    contiguous rows ``vals`` / ``idx``; past the kernel's shared memory
    (``cosine_select_sort_cap``) it sorts in a scratch of its own."""
    b, n = scores.shape
    lib = _build.library()
    scratch, width = None, 0
    if k > lib.cosine_select_sort_cap():
        width = 1 << (k - 1).bit_length()
        scratch = torch.empty((b, width), dtype=torch.int64,
                              device=scores.device)
    with _on(scores.device):
        _build.check(lib.cosine_select_launch(
            scores.data_ptr(), b, n, k, vals.data_ptr(), idx.data_ptr(),
            None if scratch is None else scratch.data_ptr(), width,
            _stream(scores.device)), "cosine_select")
        LAUNCHES["select"] += 1


# The top-k launch, on CUDA tensors, with its lists where asked: they are
# exposed so that the tile pass can be held to its plain version alone.
def topk_lists(query: torch.Tensor, store: torch.Tensor, k: int, count: int,
               lists: bool = True):
    """``cosine_score_tile`` in top-k mode: ``(values [B,k] f32, indices
    [B,k] int32)``, and where ``lists`` is set the launch's scratch, each
    segment's top k as ``(part_vals [B,n_seg,k] f32, part_idx [B,n_seg,k]
    int32)``, a segment being ``segment_rows(n, device)`` rows; k at most
    ``LIST_K``.  One buffer holds all four; the views are made after the
    launch, so that the card starts as soon as it can."""
    if not 0 < k <= LIST_K:
        raise ValueError(f"k={k}: the kernel keeps lists of 1..{LIST_K}")
    store, ld, per_launch = _check_kernel_inputs(query, store, k)
    b, n = query.shape[0], store.shape[0]
    dev = query.device
    tpb = segment_tiles(n, dev)
    n_seg = -(-n // (tpb * _tile_rows()))
    top, part = b * k, b * n_seg * k            # words of each
    buf = torch.empty(2 * (top + part), dtype=torch.float32, device=dev)
    at = buf.data_ptr()
    with _on(dev):
        stream = _stream(dev)
        slot = _counter_slot(dev.index, stream)
        for s in range(0, b, per_launch):
            _launch(query[s:s + per_launch] if b > per_launch else query,
                    store, ld, count, k, tpb, stream,
                    parts=(at + 4 * (2 * top + s * n_seg * k),
                           at + 4 * (2 * top + part + s * n_seg * k)),
                    top=(at + 4 * s * k, at + 4 * (top + s * k)), slot=slot)
            LAUNCHES["score_topk"] += 1
    out = (buf[:top].view(b, k),
           buf[top:2 * top].view(torch.int32).view(b, k))
    if lists:
        out += (buf[2 * top:2 * top + part].view(b, n_seg, k),
                buf[2 * top + part:].view(torch.int32).view(b, n_seg, k))
    return out


def topk_partials(query: torch.Tensor, store: torch.Tensor, k: int,
                  count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lists of ``topk_lists``'s launch alone."""
    return topk_lists(query, store, k, count)[2:]


def topk_partials_ref(query: torch.Tensor, store: torch.Tensor, k: int,
                      count: int, tile: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``topk_partials`` for segments of ``tile`` rows
    (``segment_rows``): rows past the store score -inf at index
    ``NO_INDEX``, as the kernel writes them."""
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
    """Plain version of the merge that ``cosine_score_tile``'s last block
    runs.  The partials run tile by tile in ascending rows, so a stable
    sort keeps ties in ascending row order."""
    b = part_vals.shape[0]
    vals, order = torch.sort(part_vals.reshape(b, -1), dim=1,
                             descending=True, stable=True)
    idx = part_idx.reshape(b, -1).gather(1, order[:, :k])
    return vals[:, :k].contiguous(), idx
