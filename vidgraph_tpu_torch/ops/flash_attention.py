"""Causal attention with a mutually visible vision prefix: the prefill's
forward, and its gradients for training.

Counterpart of ``vidgraph_tpu/models/captioner.py::_attn_flash``, which
runs JAX's Pallas TPU ``flash_attention`` (causal, blocks of 512/384/256/
128 over a sequence padded by ``flash_pad_len``; a ``custom_vjp`` whose
backward is two more Pallas kernels, ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``) and then recomputes the nv x nv vision-prefix
corner densely.  Here the forward is the CUDA C++ kernel ``flash_attn_fwd``
of ``csrc/flash_attention.cu`` and the backward the kernels
``flash_bwd_delta``, ``flash_bwd_fused`` and ``flash_bwd_dq_convert`` of
``csrc/flash_attention_bwd.cu``, all of which fold the whole mask into one
pass: key ``c`` is visible to query ``r`` iff ``c <= max(r, nv - 1)``, the
rule of the einsum path's mask (``captioner.py:282-284``).  They take any
T; the TPU's padding is not carried over.

What bounds it on the H100: at the serving shape (b_pad x 2056 tokens, 8
heads of 64) the plain version writes and reads a [B, h, T, T] float32
probability tensor per layer, 4.3 GB at B = 32, and autograd through it
keeps that tensor per layer for the backward.  The kernels keep scores and
probabilities in registers (FlashAttention's online softmax), read q, k, v
once per 64-row tile of the other side and write only the outputs; the
backward recomputes the probabilities from one float32 residual per row,
the log-sum-exp ``L`` [B, h, T] (the TPU kernel saves the running max and
sum separately).

Numerics: q, k, v and the output are bfloat16 [B, T, h, hd], hd 64 (the
base, chat and mid-scale widths) or 128 (``CaptionerConfig.large()``);
scores, the running max and sum and the output are accumulated in float32,
with scale ``1/sqrt(hd)``.  The unnormalised probabilities are rounded to
bfloat16 before P.V (the tensor-core operand), where the plain version
rounds the normalised ones, as the JAX einsum path does; the two agree to
bfloat16 rounding (``TOL_ABS + TOL_REL * |ref|``).  The backward rounds P
and dS to bfloat16 as tensor-core operands and dq, dk, dv once on the way
out; the plain backward (``attention_bwd_ref``) is float32 throughout.
One fused pass computes S and dP once for dk, dv (written by the block that
owns them: two runs give the same bits) and dq (summed across key tiles by
float32 atomics into an accumulator: its last bits may differ between
runs).

Dispatch: ``flash_attention`` takes the plain version for a tensor on the
CPU, or with ``flash=False`` (the ``VIDGRAPH_NO_FLASH_PREFILL`` opt-out);
a CUDA tensor otherwise launches the kernels or raises.  Under autograd
(gradients enabled and an input requiring one) the CUDA path goes through
``FlashAttentionFn``, which saves q, k, v, the output and ``L``; otherwise
it is one ``flash_fwd`` launch and nothing is saved.  ``LAUNCHES`` counts
kernel launches, ``REF_CALLS`` the plain forward's calls.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build

TOL_ABS, TOL_REL = 1e-2, 2e-2   # kernel vs plain version, bf16 outputs

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_delta": 0,
                            "flash_bwd_fused": 0, "flash_bwd_dq_convert": 0}
REF_CALLS = 0


def reset_counts() -> None:
    global REF_CALLS
    for name in LAUNCHES:
        LAUNCHES[name] = 0
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
    (the caller casts, as ``_block`` does).  Differentiable: autograd
    through it is the training path's einsum attention."""
    b, t, h, hd = q.shape
    att = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(hd)
    mask = prefix_causal_mask(t, nv, q.device)
    att = att.masked_fill_(~mask, -1e30)
    att = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", att.float(), v.float())


def lse_ref(q: torch.Tensor, k: torch.Tensor, nv: int) -> torch.Tensor:
    """Plain version of the forward's residual: float32 [B, h, T],
    ``L[r] = log sum_c exp(q[r].k[c] / sqrt(hd))`` over the visible keys."""
    t, hd = q.shape[1], q.shape[3]
    att = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(hd)
    att = att.masked_fill_(~prefix_causal_mask(t, nv, q.device), -1e30)
    return torch.logsumexp(att, dim=-1)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      nv: int, use_delta: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: (dq, dk, dv), float32
    [B, T, h, hd], from q, k, v, the forward's output ``o`` and residual
    ``lse`` [B, h, T] and the output's gradient ``do``, with the
    probabilities P [B, h, T, T] materialised in float32:
    ``P = exp(scale q.k - L)`` where visible, ``delta = rowsum(dO * o)``,
    ``dV = P^T dO``, ``dS = P * (dO V^T - delta)``, ``dQ = scale dS K``,
    ``dK = scale dS^T Q``.  ``use_delta=False`` leaves ``delta`` out: the
    planted fault that the card's checks must catch."""
    t, hd = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(p - lse[..., None])
    p = p.masked_fill_(~prefix_causal_mask(t, nv, q.device), 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    ds = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    if use_delta:
        delta = (dof * o.float()).sum(-1).transpose(1, 2)   # [B, h, T]
        ds = ds - delta[..., None]
    ds = ds.mul_(p)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    nv: int, flash: bool = True) -> torch.Tensor:
    """Attention over [B, T, h, hd]: the CUDA kernels for a CUDA tensor
    (bfloat16 output; differentiable through ``FlashAttentionFn``), the
    plain version (float32 output, differentiable through autograd) for a
    CPU tensor or with ``flash=False``."""
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, nv)
    return _cuda_flash(q, k, v, nv)[0]


def _check_inputs(lib, **tensors: torch.Tensor) -> None:
    """Raise on what the kernels do not take: every tensor [B, T, h, hd]
    bfloat16, contiguous, 16-byte aligned, on one CUDA device, hd 64 or
    128, B*h within the grid's second dimension."""
    first = next(iter(tensors.values()))
    b, t, h, hd = first.shape
    if not lib.flash_takes_head_dim(hd):
        raise ValueError(f"head dim {hd}: the kernel takes 64 or 128")
    for name, x in tensors.items():
        if x.shape != first.shape or x.device != first.device:
            raise ValueError(f"{name} {tuple(x.shape)} on {x.device} does "
                             f"not match {tuple(first.shape)} on "
                             f"{first.device}")
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


def _cuda_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nv: int,
                with_lse: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One ``flash_fwd`` launch: (out [B, T, h, hd] bfloat16, and with
    ``with_lse`` the residual L [B, h, T] float32, else None)."""
    b, t, h, hd = q.shape
    lib = _build.library()
    _check_inputs(lib, q=q, k=k, v=v)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        _build.check(lib.flash_attn_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None,
            b, t, h, hd, nv, torch.cuda.current_stream().cuda_stream),
            "flash_attn_fwd")
        LAUNCHES["flash_fwd"] += 1
    return out, lse


def _check_rows(name: str, x: torch.Tensor, like: torch.Tensor) -> None:
    """``x`` must be contiguous float32 [B, h, T] beside ``like``
    [B, T, h, hd]."""
    b, t, h, _ = like.shape
    if (x.shape != (b, h, t) or x.dtype != torch.float32
            or not x.is_contiguous() or x.device != like.device):
        raise ValueError(f"{name} must be contiguous float32 [B, h, T] on "
                         f"{like.device}, got {x.dtype} {tuple(x.shape)}")


def _cuda_delta(out: torch.Tensor, dout: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``flash_bwd_delta`` launch: (``rowsum(dout * out)`` as float32
    [B, h, T], and the zeroed float32 dq accumulator [B, T, h, hd])."""
    b, t, h, hd = out.shape
    lib = _build.library()
    _check_inputs(lib, out=out, dout=dout)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=out.device)
    dq_accum = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    with torch.cuda.device(out.device):
        _build.check(lib.flash_bwd_delta_launch(
            out.data_ptr(), dout.data_ptr(), delta.data_ptr(),
            dq_accum.data_ptr(), b, t, h, hd,
            torch.cuda.current_stream().cuda_stream), "flash_bwd_delta")
        LAUNCHES["flash_bwd_delta"] += 1
    return delta, dq_accum


def _cuda_bwd_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dout: torch.Tensor, lse: torch.Tensor,
                    delta: torch.Tensor, dq_accum: torch.Tensor, nv: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``flash_bwd_fused`` launch: (dk, dv), bfloat16 [B, T, h, hd];
    the unscaled dq is added into ``dq_accum``."""
    b, t, h, hd = q.shape
    lib = _build.library()
    _check_inputs(lib, q=q, k=k, v=v, dout=dout)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    _check_accum(dq_accum, q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _build.check(lib.flash_bwd_fused_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dq_accum.data_ptr(), b, t, h, hd, nv,
            torch.cuda.current_stream().cuda_stream), "flash_bwd_fused")
        LAUNCHES["flash_bwd_fused"] += 1
    return dk, dv


def _check_accum(x: torch.Tensor, like: torch.Tensor) -> None:
    """``x`` must be contiguous float32 shaped as ``like`` on its device."""
    if (x.shape != like.shape or x.dtype != torch.float32
            or not x.is_contiguous() or x.device != like.device):
        raise ValueError(f"dq_accum must be contiguous float32 "
                         f"{tuple(like.shape)} on {like.device}, got "
                         f"{x.dtype} {tuple(x.shape)}")


def _cuda_dq_convert(dq_accum: torch.Tensor) -> torch.Tensor:
    """One ``flash_bwd_dq_convert`` launch: dq = bf16(dq_accum /
    sqrt(hd)), [B, T, h, hd]."""
    lib = _build.library()
    hd = dq_accum.shape[-1]
    if dq_accum.dim() != 4 or not lib.flash_takes_head_dim(hd):
        raise ValueError(f"dq_accum {tuple(dq_accum.shape)}: [B, T, h, hd] "
                         "with hd 64 or 128")
    _check_accum(dq_accum, dq_accum)
    dq = torch.empty(dq_accum.shape, dtype=torch.bfloat16,
                     device=dq_accum.device)
    with torch.cuda.device(dq_accum.device):
        _build.check(lib.flash_bwd_dq_convert_launch(
            dq_accum.data_ptr(), dq.data_ptr(), dq_accum.numel(), hd,
            torch.cuda.current_stream().cuda_stream), "flash_bwd_dq_convert")
        LAUNCHES["flash_bwd_dq_convert"] += 1
    return dq


def _cuda_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                    nv: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three backward launches: (dq, dk, dv), bfloat16 [B, T, h, hd]."""
    delta, dq_accum = _cuda_delta(out, dout)
    dk, dv = _cuda_bwd_fused(q, k, v, dout, lse, delta, dq_accum, nv)
    return _cuda_dq_convert(dq_accum), dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` on the card under autograd: the forward kernel
    with its residual, and the backward kernels for (dq, dk, dv).  The
    counterpart of the ``jax.custom_vjp`` around the TPU kernel."""

    @staticmethod
    def forward(ctx, q, k, v, nv: int):
        out, lse = _cuda_flash(q, k, v, nv, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.nv = nv
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(torch.bfloat16).contiguous()
        dq, dk, dv = _cuda_flash_bwd(q, k, v, out, lse, dout, ctx.nv)
        return dq, dk, dv, None
