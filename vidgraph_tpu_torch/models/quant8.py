"""Weight-only int8 serving quantisation for the decoder stack.

Counterpart of ``vidgraph_tpu/models/quant8.py``.  A decode step at a small
batch reads every block matrix once and does little with it, so the bytes
of the weights set its floor; storing the block matrices as int8 with one
float32 scale per output channel halves those bytes against bfloat16.

A quantised weight is a :class:`Q8` (``q`` int8 [..., out], ``s`` float32
[out]), so a quantised tree keeps the layout of
``models/captioner.py::init_params``: the forward and the decode send every
weight product through :func:`wdot`, which takes float and ``Q8`` leaves
alike.  ``wdot`` has the JAX package's three int8 modes, with its
roundings:

* ``a16``: ``x @ q.to(dtype)``, rounded to ``dtype``, times ``s`` in
  float32, rounded to ``dtype``.  PyTorch has no convert fused into a
  product, so this writes a ``dtype`` [K, N] matrix at every call.
* ``a8``: the activation quantised per row on the fly, an int8 x int8
  product with exact int32 sums, times both scales in float32
  (:func:`a8_dot`, shared with ``models/vit_quant.py``).
* ``a16p``: the hand-written kernel of ``ops/q8_matmul.py``, for a CUDA
  tensor with at most 64 rows and K, N multiples of 128 (the float32 sum
  times ``s``, rounded to ``dtype`` once: the kernel writes a bfloat16
  output itself, one launch a product); every other shape, and a CPU
  tensor, takes ``a16``, as the JAX package does off the TPU.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops import q8_matmul as q8_op


class Q8:
    """int8 weight [..., out] and its per-output-channel float32 scale."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor) -> None:
        self.q = q
        self.s = s

    @property
    def shape(self):
        return self.q.shape

    def to(self, device) -> "Q8":
        return Q8(self.q.to(device), self.s.to(device))

    def __repr__(self) -> str:
        return f"Q8(q={tuple(self.q.shape)}, s={tuple(self.s.shape)})"


def is_q8(w: Any) -> bool:
    return isinstance(w, Q8)


def quantize_matrix(w: torch.Tensor) -> Q8:
    """[..., out] float -> int8, symmetric, one scale per output channel:
    the abs-max over every other axis over 127 (at least 1e-8), values
    rounded half to even and clipped to +-127."""
    w = w.float()
    s = w.abs().amax(dim=tuple(range(w.dim() - 1))) / 127.0
    s = torch.clamp(s, min=1e-8)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return Q8(q, s)


# the decoder-block matrices carry ~99.6% of CaptionerConfig.large()'s
# bytes; embeddings and layer norms stay in their stored dtype
BLOCK_KEYS = ("qkv_w", "attn_o_w", "fc1_w", "fc2_w")


def quantize_captioner_params(params: Dict, head: bool = True) -> Dict:
    """Quantise a captioner tree (``models/captioner.py`` layout) for
    serving: the block matrices always, ``head_w`` ([d, vocab], small but
    read every step) unless ``head`` is False."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    if head:
        out["head_w"] = quantize_matrix(params["head_w"])
    out["blocks"] = [
        {k: (quantize_matrix(v) if k in BLOCK_KEYS else v)
         for k, v in bp.items()}
        for bp in params["blocks"]
    ]
    return out


def _int8_product(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """xq [M, K] int8 @ q [K, N] int8 -> int32 [M, N], exact.  (A float32
    or bfloat16 product of the whole K would not be: |sum| reaches
    127^2 K, past 2^24 from K = 1041.)  On the card, with K a multiple of
    128 (every decoder and ViT width), ``torch._int_mm`` (cuBLASLt, int32
    sums), which takes more than 16 rows and N a multiple of 8: the
    operands are padded with zeros up to that.  cuBLASLt refuses some
    other K, so those take a float64 product, exact up to 2^53."""
    if xq.device.type != "cuda":
        return xq.to(torch.int32) @ q.to(torch.int32)
    m, k = xq.shape
    n = q.shape[1]
    if k % 128:
        return (xq.double() @ q.double()).to(torch.int32)
    xq = F.pad(xq, (0, 0, 0, max(m, 17) - m))
    q = F.pad(q, (0, -n % 8)) if n % 8 else q
    return torch._int_mm(xq, q)[:m, :n]


def a8_dot(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x @ (q * s)`` with the activation quantised per row on the fly:
    x [..., K] float, q [K, N] int8, s [N] float32 -> float32 [..., N] =
    ``int32(xq @ q) * sx * s``, ``sx`` the row's abs-max over 127 (at
    least 1e-8)."""
    xf = x.float()
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-8)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    acc = _int8_product(xq.reshape(-1, xq.shape[-1]), q)
    return acc.reshape(*x.shape[:-1], q.shape[1]).float() * sx * s


def wdot(x: torch.Tensor, w: Any, dtype: torch.dtype,
         mode: str = "a16") -> torch.Tensor:
    """``x @ w`` for a float matrix or a :class:`Q8`; the output is in
    ``dtype``, from float32 sums.  ``mode`` (a16 | a8 | a16p) is read by
    ``Q8`` leaves only."""
    if not is_q8(w):
        return x.to(dtype) @ w.to(dtype)
    if mode == "a16p":
        lead = math.prod(x.shape[:-1])
        k, n = w.q.shape
        if (x.is_cuda and lead <= q8_op.MAX_M and k % 128 == 0
                and n % 128 == 0):
            out = dtype if dtype in (torch.float32,
                                     torch.bfloat16) else torch.float32
            y = q8_op.q8_matmul(x.reshape(lead, k), w.q, w.s, out)
            return y.reshape(*x.shape[:-1], n).to(dtype)
        mode = "a16"
    if mode == "a8":
        return a8_dot(x, w.q, w.s).to(dtype)
    y = x.to(dtype) @ w.q.to(dtype)
    return (y.float() * w.s).to(dtype)


def tree_bytes(params: Any) -> int:
    """Bytes of the (possibly mixed) serving tree's tensors."""
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(tree_bytes(v) for v in params)
    if is_q8(params):
        return tree_bytes(params.q) + tree_bytes(params.s)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0
