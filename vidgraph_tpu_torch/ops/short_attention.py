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

Dispatch: ``fused_short_attention`` takes the plain version for a tensor
on the CPU; a CUDA tensor launches the kernel or raises.  An odd head count raises, as in the JAX package.
``LAUNCHES`` counts kernel launches, ``REF_CALLS`` the plain version's
calls.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from . import _build

# kernel vs plain version (bf16 outputs): about one bf16 ulp, the same
# roundings in another summation order; TOL_F32 holds float32 plain
# versions to the JAX package's
TOL_F32 = 1e-5
TOL_ABS, TOL_REL = 1e-2, 2e-2

LAUNCHES: Dict[str, int] = {"short_attention": 0}
REF_CALLS = 0


def reset_counts() -> None:
    global REF_CALLS
    LAUNCHES["short_attention"] = 0
    REF_CALLS = 0


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
    """Exact MHA over [B, h, N, hd] (h even): the CUDA kernel for a CUDA
    tensor (bf16, hd 64: the ViT-B/32 heads), the plain version for a CPU
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


def _cuda_short_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    b, h, n, hd = q.shape
    lib = _build.library()
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {x.dtype}; the kernel takes "
                             "bfloat16")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if hd != lib.short_attention_head_dim():
        raise ValueError(f"head dim {hd}: the kernel takes "
                         f"{lib.short_attention_head_dim()}")
    strides = q.stride()
    if k.stride() != strides or v.stride() != strides or strides[3] != 1:
        raise ValueError("q, k and v must share strides, with hd "
                         "contiguous")
    if any(st % 8 for st in strides[:3]):
        raise ValueError(f"strides {strides}: rows must start on 16 bytes")
    if not 1 <= n <= lib.short_attention_max_tokens():
        raise ValueError(f"N = {n}: the kernel takes 1 to "
                         f"{lib.short_attention_max_tokens()} tokens")
    if not 1 <= b * h <= 2 ** 31 - 1:
        raise ValueError(f"B*h = {b * h} out of the kernel's grid")
    out = torch.empty((b, h, n, hd), device=q.device, dtype=q.dtype)
    with torch.cuda.device(q.device):
        _build.check(lib.short_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, n, strides[0], strides[1], strides[2],
            torch.cuda.current_stream().cuda_stream), "short_attention")
        LAUNCHES["short_attention"] += 1
    return out
