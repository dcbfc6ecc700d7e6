"""Weight-only int8 product for small-M decode steps.

Counterpart of ``vidgraph_tpu/ops/q8_matmul.py``.  The TPU kernel there,
``_kernel`` (the ``pallas_call`` in ``q8_matmul``), converts an int8 weight
tile to bfloat16 in VMEM so that one byte a weight crosses device memory;
here ``q8_matmul`` is the CUDA C++ kernel of ``csrc/q8_matmul.cu``, which
computes the same function:

    out[M, N] = (bf16(x)[M, K] . bf16(q)[K, N]) * s[N]          float32

x rounded to bfloat16, the int8 weights converted on the chip (exact), the
products summed in float32, the per-column scale applied to the float32
sum, float32 out (or that rounded to bfloat16).  It is reached from ``models/quant8.py::wdot`` with
``qmode='a16p'``, for M <= 64 and K, N multiples of 128.  A direct call
takes any M, as the TPU kernel does (it pads M to a multiple of 16):
``slabs`` cuts M > 64 into 64-row slabs, one launch of the kernel's plan
each, written into the rows of one output (rows are independent, so this
is exact); M <= 64 is one launch, as before.

What bounds it on the H100: bytes, the K x N int8 weights.  PyTorch has no
convert fused into a product: the plain ``a16`` expression
``x @ q.to(bfloat16)`` writes and re-reads a bfloat16 [K, N] matrix every
call, five bytes a weight against the kernel's one.  The kernel is one
launch a product: blocks of 128 weight columns, the weights and x brought
by TMA, K split over the blocks of one thread-block cluster where the
column blocks alone would leave the card's SMs idle, the partial sums added
in rank order through distributed shared memory (so two runs give the same
bits).  ``plan`` picks the split, in Python.  ``out_dtype`` bfloat16 writes
the float32 result rounded to nearest even, bit for bit its ``.to``.

``q8_matmul_ref`` is the plain version.  Dispatch: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.  K or N off a
multiple of 128 raises ``ValueError``, as in the JAX package.
``LAUNCHES`` counts kernel launches (one a product), ``REF_CALLS`` the
plain version's calls.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import _build

_LANE = 128
# q8_matmul.cu's limits: rows, K rows a stage, columns a block, blocks a
# cluster (its launch function refuses what is outside them)
MAX_M = 64
TILE_K, TILE_N = 64, 128
MAX_CLUSTER = 8
MIN_RANK_TILES = 8
H100_SMS = 132

# kernel vs plain version: max |err| <= TOL_REL * max |plain|.  Both sum
# exact products (8-bit by 8-bit significands) in float32; only the order of
# the K additions differs.
TOL_REL = 1e-4

LAUNCHES: Dict[str, int] = {"q8_matmul": 0}
REF_CALLS = 0


def reset_counts() -> None:
    global REF_CALLS
    LAUNCHES["q8_matmul"] = 0
    REF_CALLS = 0


def q8_matmul_ref(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: ``(bf16(x) @ q) * s`` in float32, then ``out_dtype``.
    x [M, K] float, q [K, N] int8, s [N] float32 -> [M, N]."""
    y = (x.to(torch.bfloat16).float() @ q.float()) * s.float()
    return y.to(out_dtype)


def slabs(m: int) -> Tuple[Tuple[int, int], ...]:
    """The launches of an [m, K] product: (first row, rows) of each slab
    of at most ``MAX_M`` rows, in order; one slab for m <= ``MAX_M``."""
    if m < 1:
        raise ValueError(f"M = {m}: at least one row")
    return tuple((r, min(MAX_M, m - r)) for r in range(0, m, MAX_M))


class Plan(NamedTuple):
    """How the kernel cuts one product: ``rows`` (M rounded up to the
    product's width: 8, 16, 32 or 64), ``column_blocks`` blocks of
    ``tile_n`` weight columns, each a cluster of ``cluster`` blocks that
    split K, rank r summing the rows ``k_ranges[r]`` = [k0, k1) of K."""
    rows: int
    tile_n: int
    tile_k: int
    column_blocks: int
    cluster: int
    k_ranges: Tuple[Tuple[int, int], ...]


def plan(m: int, k: int, n: int, sms: int = H100_SMS,
         cluster: Optional[int] = None) -> Plan:
    """The kernel's partition of ``[m, k] x [k, n]``: N in tiles of
    ``TILE_N`` columns, one block each; where those are fewer than the
    card's ``sms``, K is split over a cluster of blocks: the largest power
    of two that keeps column blocks x cluster near ``sms`` (at most
    ``sms / column blocks``, rounded), at most ``MAX_CLUSTER``, and leaves
    each rank at least ``MIN_RANK_TILES`` tiles of ``TILE_K`` rows (the
    cluster's reduction costs more than a few tiles' streaming:
    PERF.md).  ``cluster`` overrides the
    choice (the card tests try every size a shape allows)."""
    if not 1 <= m <= MAX_M:
        raise ValueError(f"M = {m}: the kernel takes 1..{MAX_M} rows")
    if k % _LANE or n % _LANE or k <= 0 or n <= 0:
        raise ValueError(f"q8_matmul needs K,N multiples of {_LANE}; "
                         f"got K={k} N={n}")
    tiles_n, tiles_k = n // TILE_N, k // TILE_K
    most = min(MAX_CLUSTER, tiles_k)
    if cluster is None:
        want = min(most, round(sms / tiles_n), tiles_k // MIN_RANK_TILES)
        cluster = 1
        while cluster * 2 <= want:
            cluster *= 2
    elif not 1 <= cluster <= most:
        raise ValueError(f"cluster = {cluster} outside 1..{most}")
    rows = next(r for r in (8, 16, 32, 64) if m <= r)
    ranges = tuple((r * tiles_k // cluster * TILE_K,
                    (r + 1) * tiles_k // cluster * TILE_K)
                   for r in range(cluster))
    return Plan(rows, TILE_N, TILE_K, tiles_n, cluster, ranges)


def _check_shapes(x, q, s) -> None:
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 1:
        raise ValueError(f"x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"s {tuple(s.shape)} must be [M, K], [K, N], [N]")
    k, n = q.shape
    if x.shape[1] != k or s.shape[0] != n:
        raise ValueError(f"x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"s {tuple(s.shape)} do not agree")
    if k % _LANE or n % _LANE or k == 0 or n == 0:
        raise ValueError(f"q8_matmul needs K,N multiples of {_LANE}; "
                         f"got K={k} N={n}")
    if q.dtype != torch.int8:
        raise ValueError(f"q is {q.dtype}; the weights are int8")


_OUT_DTYPES = (torch.float32, torch.bfloat16)


def q8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x [M, K] float, q [K, N] int8, s [N] float32 -> [M, N] in
    ``out_dtype`` (float32 or bfloat16): the CUDA kernel for CUDA tensors
    (one launch a 64-row slab of ``slabs(M)``), the plain version for CPU
    tensors."""
    global REF_CALLS
    _check_shapes(x, q, s)
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype}: float32 or bfloat16")
    if not (x.device == q.device == s.device):
        raise ValueError("x, q and s must lie on one device")
    if x.device.type == "cpu":
        REF_CALLS += 1
        return q8_matmul_ref(x, q, s, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no q8_matmul kernel for {x.device}")
    return _cuda_q8_matmul(x, q, s, out_dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_plan = functools.lru_cache(maxsize=1024)(plan)


def _cuda_q8_matmul(x, q, s, out_dtype=torch.float32,
                    cluster: Optional[int] = None):
    """Launch the kernel once a slab of ``slabs(M)``; ``cluster``
    overrides ``plan``'s choice (the card tests hold every split of K to
    the plain version through it)."""
    m, k = x.shape
    n = q.shape[1]
    dev = x.device
    parts = slabs(m)
    plans = [_plan(rows, k, n, _sm_count(dev.index), cluster)
             for _, rows in parts]
    lib = _build.library()
    if x.dtype != torch.bfloat16:
        if not x.is_floating_point():
            raise ValueError(f"x is {x.dtype}; the kernel takes a float "
                             "type")
        x = x.to(torch.bfloat16)
    if not x.is_contiguous():
        x = x.contiguous()
    if s.dtype != torch.float32 or not s.is_contiguous():
        s = s.float().contiguous()
    if not q.is_contiguous():
        raise ValueError("q must be contiguous [K, N]")
    ptrs = (x.data_ptr(), q.data_ptr(), s.data_ptr())
    if (ptrs[0] | ptrs[1] | ptrs[2]) % 16:
        raise ValueError("x, q and s must be 16-byte aligned")
    out = torch.empty((m, n), device=dev, dtype=out_dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16_out = int(out_dtype == torch.bfloat16)
    for (r0, rows), p in zip(parts, plans):
        # row r0 of x and of out: K * 2 and N * out bytes a row, multiples
        # of 16 bytes, so the slabs stay 16-byte aligned
        args = (ptrs[0] + r0 * k * 2, *ptrs[1:],
                out.data_ptr() + r0 * n * out.element_size(), rows, k, n,
                p.cluster, bf16_out, stream)
        if dev.index == torch.cuda.current_device():
            err = lib.q8_matmul_launch(*args)
        else:
            with torch.cuda.device(dev):
                err = lib.q8_matmul_launch(*args)
        _build.check(err, "q8_matmul")
        LAUNCHES["q8_matmul"] += 1
    return out
