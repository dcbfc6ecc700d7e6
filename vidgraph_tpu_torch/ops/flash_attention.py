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
sum separately).  What is left is tensor-core work: the forward runs both
products on Hopper's ``wgmma`` (one warpgroup per 64 query rows, P from
registers, V read in place through the descriptor's transpose bit) with K
and V brought by TMA into a three-stage swizzled ring (the tensor maps
are encoded by libcuda's ``cuTensorMapEncodeTiled``, looked up at run
time).

Routes (``flash_route``, on dtype and hd, before the launch): bfloat16 at
hd 64 (the base, chat and mid-scale widths) or 128
(``CaptionerConfig.large()``) takes the kernels above ("wgmma"); every
other input the TPU kernel takes (float32, float16, any hd: the tiny and
tiny64 captioners' hd 32, widths such as 640 / 8 heads = 80) takes the
general kernels of ``csrc/attention_general*.cu`` ("general":
``attn_general_fwd``, ``attn_general_bwd_delta``, ``attn_general_bwd``,
``attn_general_dq_convert``), which compute the same function: 16-bit
inputs on ``mma.sync`` tensor-core products with the wgmma kernels'
roundings, float32 inputs with float32 FMAs (never rounded, no TF32).
``general_plan`` picks their instantiation: the head-dim maximum (the
forward 64, 128 or 256, the backward 64 or 128; wider heads take output
blocks of that width) and whether every row lies on 16 bytes (cp.async
copies; else element loads).  Both routes take any T and any B x h (the
wgmma kernels fold B x h over two grid dimensions).  A CUDA tensor never
takes the plain version: a failed build or launch raises.

Numerics of the wgmma route: q, k, v and the output are bfloat16
[B, T, h, hd]; scores, the running max and sum and the output are
accumulated in float32, with scale ``1/sqrt(hd)``.  The unnormalised probabilities are rounded to
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

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import _build

TOL_ABS, TOL_REL = 1e-2, 2e-2   # kernel vs plain version, bf16 outputs
# float16 outputs: the bfloat16 tolerance scaled by the ratio of the two
# types' units in the last place (2^-10 / 2^-7)
TOL_F16_ABS, TOL_F16_REL = 1.25e-3, 2.5e-3
# float32: the forward within 1e-5 (the same float32 arithmetic in another
# summation order); the gradients within 1e-5 + 1e-4 |plain|, sums over
# T keys or queries
TOL_F32 = 1e-5
BWD_TOL_F32_ABS, BWD_TOL_F32_REL = 1e-5, 1e-4

FLOAT_TYPES = (torch.float32, torch.bfloat16, torch.float16)
# the type codes of attention_general.cu's entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the head dims flash_attention.cu is instantiated for (bfloat16)
WGMMA_HEAD_DIMS = (64, 128)
# the head-dim maxima the general kernels are instantiated for: forward,
# backward (dK and dV of 16 keys x 128 dims fill half a thread's registers)
GENERAL_FWD_DIMS, GENERAL_BWD_DIMS = (64, 128, 256), (64, 128)

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_delta": 0,
                            "flash_bwd_fused": 0, "flash_bwd_dq_convert": 0,
                            "flash_fwd_general": 0,
                            "flash_bwd_general_delta": 0,
                            "flash_bwd_general": 0,
                            "flash_bwd_general_dq_convert": 0}
REF_CALLS = 0


def reset_counts() -> None:
    global REF_CALLS
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    REF_CALLS = 0


def flash_route(dtype: torch.dtype, hd: int) -> str:
    """The kernels a [B, T, h, hd] input of ``dtype`` takes on the card:
    "wgmma" (bfloat16 at hd 64 or 128, ``csrc/flash_attention.cu`` and
    ``flash_attention_bwd.cu``) or "general" (every other float type and
    head dim, ``csrc/attention_general.cu``).  Raises only for what the
    TPU kernel does not take either: a type that is not floating point, or
    hd < 1."""
    if dtype not in FLOAT_TYPES:
        raise ValueError(f"{dtype}: the attention kernels take "
                         "float32, bfloat16 or float16")
    if hd < 1:
        raise ValueError(f"head dim {hd}")
    return ("wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS
            else "general")


def general_plan(hd: int, *tensors: torch.Tensor,
                 backward: bool = False) -> Tuple[int, bool]:
    """The general kernels' instantiation for [B, h, T, hd] views (any
    order of the first three dims) of one float type: (the smallest
    head-dim maximum that holds ``hd``, else the largest, whose output
    blocks then split hd; whether every row of every tensor lies on 16
    bytes: pointers and the strides of dims longer than 1 on 16 bytes, hd
    contiguous and a whole number of 16-byte chunks)."""
    dims = GENERAL_BWD_DIMS if backward else GENERAL_FWD_DIMS
    d_max = next((d for d in dims if hd <= d), dims[-1])
    vec = 16 // tensors[0].element_size()
    if hd % vec:
        return d_max, False
    for x in tensors:
        if x.data_ptr() % 16:
            return d_max, False
        # a contiguous view's strides are multiples of hd
        if not x.is_contiguous():
            st = x.stride()
            if st[3] != 1 or any(st[i] % vec for i in range(3)
                                 if x.shape[i] > 1):
                return d_max, False
    return d_max, True


def tolerance(dtype: torch.dtype) -> Tuple[float, float]:
    """(abs, rel) of the forward's ``|kernel - plain| <= abs + rel |plain|``
    (the plain version rounded to ``dtype``) at inputs of ``dtype``."""
    return {torch.bfloat16: (TOL_ABS, TOL_REL),
            torch.float16: (TOL_F16_ABS, TOL_F16_REL),
            torch.float32: (TOL_F32, 0.0)}[dtype]


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
    """Attention over [B, T, h, hd]: the CUDA kernels of ``flash_route``
    for a CUDA tensor (output in the input's type; differentiable through
    ``FlashAttentionFn``), the plain version (float32 output,
    differentiable through autograd) for a CPU tensor or with
    ``flash=False``."""
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


def _check_inputs(route: str, **tensors: torch.Tensor) -> None:
    """Raise on what the kernels do not take: every tensor [B, T, h, hd]
    of one float type, contiguous, on one CUDA device, T >= 1; on the
    wgmma route also bfloat16 at hd 64 or 128 and 16-byte aligned (TMA
    and 16-byte loads)."""
    first = next(iter(tensors.values()))
    if route == "wgmma" and flash_route(first.dtype,
                                        first.shape[-1]) != "wgmma":
        raise ValueError(f"{first.dtype} {tuple(first.shape)}: the wgmma "
                         "kernels take bfloat16 with hd 64 or 128")
    for name, x in tensors.items():
        if x.shape != first.shape or x.device != first.device:
            raise ValueError(f"{name} {tuple(x.shape)} on {x.device} does "
                             f"not match {tuple(first.shape)} on "
                             f"{first.device}")
        if x.dtype != first.dtype:
            raise ValueError(f"{name} is {x.dtype}, not {first.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if route == "wgmma" and x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if first.shape[1] == 0:
        raise ValueError("T = 0: the kernels take at least one token")


# the four views' element strides, each in (batch, head, token, dim) order
_Strides16 = ctypes.c_longlong * 16


def general_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: Optional[torch.Tensor], nv: int,
                    two_pass: bool, heads_first: bool) -> None:
    """One ``attn_general_fwd`` launch into ``out`` (and ``lse`` [B, h, T]
    float32, or None): q, k, v, out of one float type, [B, T, h, hd]
    (``heads_first`` False) or [B, h, T, hd] views at any strides;
    ``two_pass`` normalises p before P.V (the short-attention kernel's
    arithmetic).  The callers count the launch."""
    if heads_first:
        b, h, t, hd = q.shape
    else:
        b, t, h, hd = q.shape
    st = []
    for x in (q, k, v, out):
        s = x.stride()
        st.extend(s if heads_first else (s[0], s[2], s[1], s[3]))
    strides = _Strides16(*st)
    d_max, aligned = general_plan(hd, q, k, v, out)
    lib = _build.library()
    _build.check(lib.attn_general_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        ctypes.addressof(strides), b, h, t, hd, nv, int(two_pass),
        DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd), d_max, int(aligned),
        torch.cuda.current_stream().cuda_stream), "attn_general_fwd")


def _cuda_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nv: int,
                with_lse: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One forward launch on ``flash_route``'s kernel: (out [B, T, h, hd]
    in the input's type, and with ``with_lse`` the residual L [B, h, T]
    float32, else None)."""
    b, t, h, hd = q.shape
    route = flash_route(q.dtype, hd)
    _check_inputs(route, q=q, k=k, v=v)
    lib = _build.library()
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        if route == "general":
            general_forward(q, k, v, out, lse, nv, False, False)
            LAUNCHES["flash_fwd_general"] += 1
            return out, lse
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
    _check_inputs("wgmma", out=out, dout=dout)
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
    _check_inputs("wgmma", q=q, k=k, v=v, dout=dout)
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
    if dq_accum.dim() != 4 or hd not in WGMMA_HEAD_DIMS:
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


def _cuda_general_delta(out: torch.Tensor, dout: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``attn_general_bwd_delta`` launch: (``rowsum(dout * out)`` as
    float32 [B, h, T], and the zeroed float32 dq accumulator)."""
    b, t, h, hd = out.shape
    _check_inputs("general", out=out, dout=dout)
    lib = _build.library()
    delta = torch.empty((b, h, t), dtype=torch.float32, device=out.device)
    dq_accum = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    with torch.cuda.device(out.device):
        _build.check(lib.attn_general_bwd_delta_launch(
            out.data_ptr(), dout.data_ptr(), delta.data_ptr(),
            dq_accum.data_ptr(), b, t, h, hd, DTYPE_CODES[out.dtype],
            torch.cuda.current_stream().cuda_stream),
            "attn_general_bwd_delta")
        LAUNCHES["flash_bwd_general_delta"] += 1
    return delta, dq_accum


def _cuda_general_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, dq_accum: torch.Tensor, nv: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ``attn_general_bwd`` launch: (dk, dv) in the input's type; the
    unscaled dq is added into ``dq_accum``."""
    b, t, h, hd = q.shape
    _check_inputs("general", q=q, k=k, v=v, dout=dout)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    _check_accum(dq_accum, q)
    lib = _build.library()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    d_max, aligned = general_plan(hd, q, k, v, dout, dk, dv, backward=True)
    with torch.cuda.device(q.device):
        _build.check(lib.attn_general_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dq_accum.data_ptr(), b, t, h, hd, nv, DTYPE_CODES[q.dtype],
            1.0 / math.sqrt(hd), d_max, int(aligned),
            torch.cuda.current_stream().cuda_stream), "attn_general_bwd")
        LAUNCHES["flash_bwd_general"] += 1
    return dk, dv


def _cuda_general_dq_convert(dq_accum: torch.Tensor,
                             dtype: torch.dtype) -> torch.Tensor:
    """One ``attn_general_dq_convert`` launch: dq = dq_accum / sqrt(hd) in
    ``dtype``, [B, T, h, hd]."""
    _check_accum(dq_accum, dq_accum)
    lib = _build.library()
    dq = torch.empty(dq_accum.shape, dtype=dtype, device=dq_accum.device)
    with torch.cuda.device(dq_accum.device):
        _build.check(lib.attn_general_dq_convert_launch(
            dq_accum.data_ptr(), dq.data_ptr(), dq_accum.numel(),
            DTYPE_CODES[dtype], 1.0 / math.sqrt(dq_accum.shape[-1]),
            torch.cuda.current_stream().cuda_stream),
            "attn_general_dq_convert")
        LAUNCHES["flash_bwd_general_dq_convert"] += 1
    return dq


def _cuda_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                    nv: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on ``flash_route``'s kernels, three launches:
    (dq, dk, dv) [B, T, h, hd] in the input's type."""
    if flash_route(q.dtype, q.shape[-1]) == "general":
        delta, dq_accum = _cuda_general_delta(out, dout)
        dk, dv = _cuda_general_bwd(q, k, v, dout, lse, delta, dq_accum, nv)
        return _cuda_general_dq_convert(dq_accum, q.dtype), dk, dv
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
        dout = dout.to(q.dtype).contiguous()
        dq, dk, dv = _cuda_flash_bwd(q, k, v, out, lse, dout, ctx.nv)
        return dq, dk, dv, None
