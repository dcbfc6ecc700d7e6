"""One rank's slices of a tensor-parallel weight, and the way back.

The JAX package states its tensor-parallel layout as ``PartitionSpec``s
(``P(None, "model")`` for a column-split [in, out] matrix) and GSPMD
places and reshards the arrays.  SPMD code holds each rank's slice
itself.  A fused q|k|v product is split by heads: each of its ``parts``
(3) is cut into the same ``m`` column ranges and a rank keeps its range of
every part, so that its columns are whole heads of q, k and v.  A plain
column split is ``parts=1``.  The JAX arrays hold the same values; only
the order of the columns inside a rank differs from a contiguous cut.
"""
from __future__ import annotations

import torch

from . import comm


def split_cols(w: torch.Tensor, group, parts: int = 1) -> torch.Tensor:
    """This rank's columns of ``w`` [..., n] (a bias is [n]): each of
    ``parts`` equal parts of the last dimension cut ``m`` ways."""
    m, r = comm.group_size(group), comm.group_rank(group)
    chunks = [p.chunk(m, dim=-1)[r] for p in w.chunk(parts, dim=-1)]
    return torch.cat(chunks, dim=-1).contiguous()


def split_rows(w: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows of ``w`` [n, ...], cut ``m`` ways."""
    m, r = comm.group_size(group), comm.group_rank(group)
    return w.chunk(m, dim=0)[r].contiguous()


def gather_cols(w: torch.Tensor, group, parts: int = 1) -> torch.Tensor:
    """The whole ``w`` from every rank's ``split_cols`` slice."""
    pieces = [p.chunk(parts, dim=-1) for p in
              comm.all_gather(w.detach().contiguous(), group)]
    return torch.cat([torch.cat([pc[i] for pc in pieces], dim=-1)
                      for i in range(parts)], dim=-1)


def gather_rows(w: torch.Tensor, group) -> torch.Tensor:
    """The whole ``w`` from every rank's ``split_rows`` slice."""
    return torch.cat(comm.all_gather(w.detach().contiguous(), group), dim=0)


def divides(n: int, group) -> bool:
    """Whether the group's size divides ``n`` (a leaf it does not divide
    stays whole, and its layer runs unsharded)."""
    return n % comm.group_size(group) == 0
