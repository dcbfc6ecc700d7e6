"""Weight-only int8 product for small-M decode steps.

Counterpart of ``vidgraph_tpu/ops/q8_matmul.py``.  The TPU kernel there,
``_kernel`` (the ``pallas_call`` in ``q8_matmul``), converts an int8 weight
tile to bfloat16 in VMEM so that one byte a weight crosses device memory;
here ``q8_matmul`` is the CUDA C++ kernel of ``csrc/q8_matmul.cu``, which
computes the same function:

    out[M, N] = (bf16(x)[M, K] . bf16(q)[K, N]) * s[N]          float32

x rounded to bfloat16, the int8 weights converted on the chip (exact), the
products summed in float32, the per-column scale applied to the float32
sum, float32 out.  It is reached from ``models/quant8.py::wdot`` with
``qmode='a16p'``, for M <= 64 and K, N multiples of 128.

What bounds it on the H100: bytes, the K x N int8 weights.  PyTorch has no
convert fused into a product: the plain ``a16`` expression
``x @ q.to(bfloat16)`` writes and re-reads a bfloat16 [K, N] matrix every
call, five bytes a weight against the kernel's one.  The kernel tiles K
(the activation does not fit shared memory whole at K = 8192) and splits
it over blocks where N alone gives too few to fill the card; the partial
sums are added in a fixed order, so two runs give the same bits
(``split_k`` picks the split, in Python).

``q8_matmul_ref`` is the plain version.  Dispatch: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.  K or N off a
multiple of 128 raises ``ValueError``, as in the JAX package.
``LAUNCHES`` counts kernel launches (one a call, the reduction pass
included), ``REF_CALLS`` the plain version's calls.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build

_LANE = 128
# q8_matmul.cu's limits: rows, K rows a stage, columns a block (its launch
# function refuses what is outside them)
MAX_M = 64
_TILE_K, _TILE_N = 64, 128
_TARGET_BLOCKS = 264       # two blocks a streaming multiprocessor of an H100

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


def q8_matmul_ref(x: torch.Tensor, q: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    """Plain version: ``(bf16(x) @ q) * s`` in float32.  x [M, K] float,
    q [K, N] int8, s [N] float32 -> float32 [M, N]."""
    return (x.to(torch.bfloat16).float() @ q.float()) * s.float()


def split_k(m: int, k: int, n: int) -> int:
    """Into how many blocks the kernel splits K: enough that the column
    blocks times the splits reach ``_TARGET_BLOCKS``, while the float32
    partial sums ([splits, M, N]) stay within half the weights' bytes and
    every split keeps at least one K tile."""
    want = -(-_TARGET_BLOCKS // (n // _TILE_N))
    return max(1, min(want, k // (8 * m), k // _TILE_K))


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


def q8_matmul(x: torch.Tensor, q: torch.Tensor,
              s: torch.Tensor) -> torch.Tensor:
    """x [M, K] float, q [K, N] int8, s [N] float32 -> float32 [M, N]:
    the CUDA kernel for CUDA tensors (M <= 64), the plain version for CPU
    tensors."""
    global REF_CALLS
    _check_shapes(x, q, s)
    if not (x.device == q.device == s.device):
        raise ValueError("x, q and s must lie on one device")
    if x.device.type == "cpu":
        REF_CALLS += 1
        return q8_matmul_ref(x, q, s)
    if x.device.type != "cuda":
        raise ValueError(f"no q8_matmul kernel for {x.device}")
    return _cuda_q8_matmul(x, q, s)


def _cuda_q8_matmul(x, q, s, splits: Optional[int] = None):
    """Launch the kernel; ``splits`` overrides ``split_k`` (the card tests
    hold every split of K to the plain version through it)."""
    m, k = x.shape
    n = q.shape[1]
    lib = _build.library()
    if not 1 <= m <= MAX_M:
        raise ValueError(f"M = {m}: the kernel takes 1..{MAX_M} rows")
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
    splits = split_k(m, k, n) if splits is None else int(splits)
    if not 1 <= splits <= k // _TILE_K:
        raise ValueError(f"splits = {splits} outside 1..{k // _TILE_K}")
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty((m, n), device=dev, dtype=torch.float32)
    partials = (torch.empty((splits, m, n), device=dev, dtype=torch.float32)
                if splits > 1 else out)
    args = (*ptrs, out.data_ptr(), partials.data_ptr(), m, k, n, splits,
            stream)
    if dev.index == torch.cuda.current_device():
        err = lib.q8_matmul_launch(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.q8_matmul_launch(*args)
    _build.check(err, "q8_matmul")
    LAUNCHES["q8_matmul"] += 1
    return out
