"""Causal attention's forward with a mutually visible prefix of ``nv``
slots: key ``c`` is visible to query ``r`` iff ``c <= max(r, nv - 1)``.

Counting rules of every count here: each input or output byte is counted
once, whatever an implementation reads again; operations are those of the
visible (query, key) pairs only, so causal attention counts at its half
(the masked half is never needed); a multiply-add is two operations.
"""
from __future__ import annotations


def visible_pairs(t: int, nv: int) -> int:
    """(query, key) pairs that one head of one row attends over."""
    nv = min(nv, t)
    return nv * nv + (t * (t + 1) - nv * (nv + 1)) // 2


def ops(b: int, h: int, t: int, hd: int, nv: int) -> int:
    """S = QK^T and O = PV over the visible pairs: 4 hd a pair."""
    return 4 * hd * visible_pairs(t, nv) * b * h


def bytes_moved(b: int, h: int, t: int, hd: int, elem: int = 2,
                lse: bool = True) -> int:
    """q, k, v read and o written, ``elem`` bytes each; with ``lse`` the
    float32 log-sum-exp a row that training keeps for the backward."""
    return 4 * b * t * h * hd * elem + (4 * b * h * t if lse else 0)
