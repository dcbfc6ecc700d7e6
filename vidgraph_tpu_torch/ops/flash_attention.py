"""Causal attention with a mutually visible vision prefix (the prefill).

Counterpart of ``vidgraph_tpu/models/captioner.py::_attn_flash``, which
runs JAX's Pallas TPU ``flash_attention`` (causal, blocks of 512/384/256/
128 over a sequence padded by ``flash_pad_len``) and then recomputes the
nv x nv vision-prefix corner densely.  Here it is the CUDA C++ kernel
``flash_attn_fwd`` of ``csrc/flash_attention.cu``, which folds the whole
mask into one pass: key ``c`` is visible to query ``r`` iff
``c <= max(r, nv - 1)``, the rule of the einsum path's mask
(``captioner.py:282-284``).  It takes any T; the TPU's padding is not
carried over.

What bounds it on the H100: at the serving shape (b_pad x 2056 tokens, 8
heads of 64) the plain version writes and reads a [B, h, T, T] float32
probability tensor per layer, 4.3 GB at B = 32.  The kernel keeps scores
and probabilities in registers (FlashAttention's online softmax), so it
reads q, k, v once per 64-row query tile and writes only the output.

Numerics: q, k, v and the output are bfloat16 [B, T, h, hd], hd 64 (the
base and chat widths) or 128 (``CaptionerConfig.large()``); scores, the
running max and sum and the output are accumulated in float32, with scale
``1/sqrt(hd)``.  The unnormalised probabilities are rounded to bfloat16
before P.V (the tensor-core operand), where the plain version rounds the
normalised ones, as the JAX einsum path does; the two agree to bfloat16
rounding (``TOL_ABS + TOL_REL * |ref|``).

Dispatch: ``flash_attention`` takes the plain version for a tensor on the
CPU, or with ``flash=False`` (the ``VIDGRAPH_NO_FLASH_PREFILL`` opt-out);
a CUDA tensor otherwise launches the kernel or raises.  ``LAUNCHES``
counts kernel launches, ``REF_CALLS`` the plain version's calls.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from . import _build

TOL_ABS, TOL_REL = 1e-2, 2e-2   # kernel vs attention_ref, bf16 outputs

LAUNCHES: Dict[str, int] = {"flash_fwd": 0}
REF_CALLS = 0


def reset_counts() -> None:
    global REF_CALLS
    LAUNCHES["flash_fwd"] = 0
    REF_CALLS = 0


def prefix_causal_mask(t: int, nv: int, device=None) -> torch.Tensor:
    """[t, t] bool, True where key ``c`` is visible to query ``r``:
    ``c <= max(r, nv - 1)``."""
    idx = torch.arange(t, device=device)
    return idx[None, :] <= torch.clamp(idx, min=nv - 1)[:, None]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  nv: int) -> torch.Tensor:
    """Plain version, the einsum path: float32 scores from the
    compute-dtype q and k scaled by ``1/sqrt(hd)``, an additive -1e30
    mask, a float32 softmax cast to the compute dtype, then P.V with
    float32 accumulation.  [B, T, h, hd] in, [B, T, h, hd] float32 out
    (the caller casts, as ``_block`` does)."""
    b, t, h, hd = q.shape
    att = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(hd)
    mask = prefix_causal_mask(t, nv, q.device)
    att = att.masked_fill_(~mask, -1e30)
    att = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", att.float(), v.float())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    nv: int, flash: bool = True) -> torch.Tensor:
    """Attention of the prefill over [B, T, h, hd]: the CUDA kernel for a
    CUDA tensor (bfloat16 output), the plain version (float32 output) for
    a CPU tensor or with ``flash=False``."""
    global REF_CALLS
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} must all be [B, T, h, hd]")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.device.type == "cpu" or not flash:
        REF_CALLS += 1
        return attention_ref(q, k, v, nv)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention kernel for device {q.device}")
    return _cuda_flash(q, k, v, nv)


def _cuda_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                nv: int) -> torch.Tensor:
    b, t, h, hd = q.shape
    lib = _build.library()
    if not lib.flash_takes_head_dim(hd):
        raise ValueError(f"head dim {hd}: the kernel takes 64 or 128")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {x.dtype}; the kernel takes "
                             "bfloat16")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if b * h > 65535 or t == 0:
        raise ValueError(f"B*h = {b * h} (at most 65535) and T = {t} "
                         "(at least 1) bound the kernel's grid")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.check(lib.flash_attn_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, t, h, hd, nv, torch.cuda.current_stream().cuda_stream),
            "flash_attn_fwd")
        LAUNCHES["flash_fwd"] += 1
    return out
