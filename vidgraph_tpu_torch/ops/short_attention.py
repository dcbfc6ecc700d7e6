"""Short-sequence (N ~ 50) attention of the ViT.

Counterpart of ``vidgraph_tpu/ops/short_attention.py``.  The TPU kernel
there, ``_fused_kernel`` (``pallas_call`` in ``fused_short_attention``),
packs head pairs into a [2N, 2N] problem with a block-diagonal mask
(``_pair_mask``) and pads it to 128 rows, to fill the TPU's 128-lane matrix
unit.  That packing is a TPU device; here ``fused_short_attention`` is the
CUDA C++ kernel ``short_attention`` of ``csrc/short_attention.cu`` (both
products on the tensor cores, mma.sync; a block a head, one warp a 16-row
query strip), which computes the same exact attention per head:

    s = (q k^T) * (1 / sqrt(hd))        float32 scores
    p = softmax(s)                       float32, then rounded to v's dtype
    out = p v                            float32 sums, out in v's dtype

What bounds it on the H100: bytes.  At the serving batch (5 frames x 12
heads, N = 50, hd = 64, bf16) one layer reads q, k, v and writes the
output, 1.54 MB: 0.46 us at 3.35 TB/s, below a launch; at 160 frames 49
MB and 1.2 GFLOP, 14.7 us.  The kernel keeps the [N, N] scores in
registers, so nothing but q, k, v and the output touches device memory.

Also here: ``packed_attention`` (the JAX package's head-pair packing, in
PyTorch ops; ``attn_impl='packed'``) and ``short_attention_ref``, the plain
per-head version of the kernel.

Routes (``short_route``, on dtype, hd, N and alignment, before the
launch): bfloat16 at hd 64 with N <= 256 and rows on 16 bytes (the
ViT-B/32 heads) takes the kernel above ("mma"); every other input that
``_fused_kernel`` takes (float32 and float16, any hd: the tiny towers'
32; any N: ViT-B/32 at a 512 input has 257 tokens) takes the two-pass
mode of ``csrc/attention_general.cu``'s ``attn_general_fwd`` ("general",
at any strides; see ``ops/flash_attention.py::general_forward``): pass 1
the row max and sum, pass 2 p normalised and rounded to v's type before
P.V, as ``_fused_kernel`` does; 16-bit inputs on the tensor cores
(``mma.sync``), float32 with float32 FMAs.

Dispatch: ``fused_short_attention`` takes the plain version for a tensor
on the CPU; a CUDA tensor launches a kernel or raises.  An odd head count raises, as in the JAX package.
``LAUNCHES`` counts kernel launches, ``REF_CALLS`` the plain version's
calls.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from . import _build
from .flash_attention import FLOAT_TYPES, general_forward, tolerance

# kernel vs plain version (bf16 outputs): about one bf16 ulp, the same
# roundings in another summation order; TOL_F32 holds float32 plain
# versions to the JAX package's.  ``tolerance(dtype)`` (the attention
# kernels' own) gives each output type's.
TOL_F32 = 1e-5
TOL_ABS, TOL_REL = 1e-2, 2e-2

# short_attention.cu's instantiation: bfloat16, hd 64, up to 4 key tiles
MMA_HEAD_DIM, MMA_MAX_TOKENS = 64, 256

LAUNCHES: Dict[str, int] = {"short_attention": 0,
                            "short_attention_general": 0}
REF_CALLS = 0


def reset_counts() -> None:
    global REF_CALLS
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    REF_CALLS = 0


def short_route(dtype: torch.dtype, hd: int, n: int,
                aligned: bool = True) -> str:
    """The kernel that [B, h, N, hd] inputs of ``dtype`` take on the card:
    "mma" (``csrc/short_attention.cu``: bfloat16, hd 64, N <= 256, rows on
    16 bytes, ``aligned``) or "general" (``attn_general_fwd`` in two
    passes: every other float type, hd and N).  Raises only for what
    ``_fused_kernel`` does not take either: a type that is not floating
    point, hd < 1 or N < 1."""
    if dtype not in FLOAT_TYPES:
        raise ValueError(f"{dtype}: the short-attention kernels take "
                         "float32, bfloat16 or float16")
    if hd < 1 or n < 1:
        raise ValueError(f"hd = {hd}, N = {n}: both must be at least 1")
    return ("mma" if dtype == torch.bfloat16 and hd == MMA_HEAD_DIM
            and n <= MMA_MAX_TOKENS and aligned else "general")


def _pair_mask(n: int, rows: int, device=None) -> torch.Tensor:
    """Additive [rows, rows] mask of a 2-head pack (the JAX package's)."""
    idx = torch.arange(rows, device=device)
    blk = torch.where(idx < n, 0, torch.where(idx < 2 * n, 1, 2))
    ok = (blk[:, None] == blk[None, :]) & (blk[None, :] < 2)
    ok = ok | ((blk[:, None] == 2) & (idx[None, :] == 0))
    return torch.where(ok, 0.0, -1e30).float()


def packed_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Exact MHA by head-pair packing, [B, h, N, hd] in and out (h even),
    as ``vidgraph_tpu.ops.short_attention.packed_attention``."""
    b, h, n, hd = q.shape
    qp, kp, vp = (x.reshape(b, h // 2, 2 * n, hd) for x in (q, k, v))
    att = torch.einsum("bgqd,bgkd->bgqk", qp.float(), kp.float())
    att = att / math.sqrt(hd)
    att = att + _pair_mask(n, 2 * n, q.device)
    att = torch.softmax(att, dim=-1).to(v.dtype)
    out = torch.einsum("bgqk,bgkd->bgqd", att.float(), vp.float())
    return out.reshape(b, h, n, hd).to(v.dtype)


def short_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Plain version, per head: ``_fused_kernel``'s arithmetic (scores
    times ``1/sqrt(hd)``, a float32 softmax, P in v's dtype, float32 P.V)
    without the pair packing.  [B, h, N, hd] in, v's dtype out."""
    hd = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * float(1.0 / hd ** 0.5)
    s = s - s.amax(dim=-1, keepdim=True)
    e = torch.exp(s)
    p = (e / e.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(v.dtype)


def fused_short_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Exact MHA over [B, h, N, hd] (h even): the CUDA kernel of
    ``short_route`` for a CUDA tensor, the plain version for a CPU
    tensor.  The inputs may be strided views (the ViT
    passes slices of one qkv product); the output is contiguous [B, h, N,
    hd] in v's dtype."""
    global REF_CALLS
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must all be [B, h, N, hd]")
    if q.shape[1] % 2:
        raise ValueError("fused_short_attention needs an even head count")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.device.type == "cpu":
        REF_CALLS += 1
        return short_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no short-attention kernel for {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "the short-attention kernel has no backward (the Pallas kernel "
            "it replaces has no VJP either): train the vision tower with "
            "attn_impl='einsum'")
    return _cuda_short_attention(q, k, v)


def _rows_aligned(*xs: torch.Tensor) -> bool:
    """Every row of q, k and v on 16 bytes, and one set of strides with hd
    contiguous: what the mma kernel's 16-byte copies need."""
    strides = xs[0].stride()
    return (all(x.stride() == strides for x in xs) and strides[3] == 1
            and not any(st % 8 for st in strides[:3])
            and not any(x.data_ptr() % 16 for x in xs))


def _cuda_short_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    b, h, n, hd = q.shape
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v are {q.dtype}, {k.dtype}, {v.dtype}: "
                         "one float type")
    route = short_route(q.dtype, hd, n, _rows_aligned(q, k, v))
    out = torch.empty((b, h, n, hd), device=q.device, dtype=q.dtype)
    if route == "general":
        with torch.cuda.device(q.device):
            general_forward(q, k, v, out, None, n, True, True)
            LAUNCHES["short_attention_general"] += 1
        return out
    lib = _build.library()
    strides = q.stride()
    with torch.cuda.device(q.device):
        _build.check(lib.short_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, n, strides[0], strides[1], strides[2],
            torch.cuda.current_stream().cuda_stream), "short_attention")
        LAUNCHES["short_attention"] += 1
    return out
