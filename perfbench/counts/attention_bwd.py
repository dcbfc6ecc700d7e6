"""Causal attention's backward with a mutually visible prefix (the mask
of ``attention_fwd.py``), under the same counting rules: each input or
output byte once, operations over the visible pairs only (causal at its
half), a multiply-add two operations.
"""
from __future__ import annotations

from .attention_fwd import visible_pairs


def ops(b: int, h: int, t: int, hd: int, nv: int) -> int:
    """dV = P^T dO, dP = dO V^T, dQ = dS K and dK = dS^T Q over the
    visible pairs: 8 hd a pair.  Recomputing S from q and k, which
    memory-saving kernels do, is not counted: the gradients do not need
    it when P is kept."""
    return 8 * hd * visible_pairs(t, nv) * b * h


def bytes_moved(b: int, h: int, t: int, hd: int, elem: int = 2) -> int:
    """q, k, v, o and dO read, dq, dk and dv written (``elem`` bytes each),
    and the forward's float32 log-sum-exp a row read."""
    return 8 * b * t * h * hd * elem + 4 * b * h * t
