"""Collectives of the port's multi-device code, and their autograd pairs.

Every collective here takes a process group (a mesh axis's,
``mesh.axis_group``) and leaves the computation where it is.  Under gloo a
CUDA tensor is staged through the host for the transfer alone (gloo's
point-to-point takes no CUDA tensor); under NCCL it stays on the card,
and a host tensor (a loop's exit flag) goes to the card for the transfer.

The autograd pairs are Megatron's, for tensor-parallel layers whose input
is replicated over the group:

* ``copy_to(x, g)``: the identity forward; the backward all-reduces the
  gradient (each rank's local heads or hidden columns saw only part of it);
* ``reduce_from(x, g)``: the all-reduce forward of a row-parallel
  product's partial sums; the backward is the identity;
* ``scatter_last(x, g)``: this rank's slice of the last dimension; the
  backward all-gathers it.

A tensor replicated over a group is assumed equal on every rank; so is its
gradient, since every rank computes the same loss.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` where ``group``'s backend takes it: the host for gloo, the
    card for NCCL (a view of ``t`` itself when it already lies there)."""
    backend = dist.get_backend(group)
    if backend == "gloo" and t.is_cuda:
        return t.cpu()
    if backend == "nccl" and not t.is_cuda:
        return t.cuda()
    return t.contiguous()


def _back(t: torch.Tensor, wire: torch.Tensor) -> torch.Tensor:
    if wire is not t:
        t.copy_(wire)
    return t


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``t`` reduced over ``group``, in place; returns ``t``."""
    if group_size(group) < 2:
        return t
    wire = _wire(t, group)
    dist.all_reduce(wire, op=op, group=group)
    return _back(t, wire)


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape on each), in group-rank order."""
    n = group_size(group)
    if n < 2:
        return [t]
    wire = _wire(t, group)
    out = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(out, wire, group=group)
    return [o.to(t.device) for o in out]


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` from group rank ``src`` on every rank, in place."""
    if group_size(group) < 2:
        return t
    wire = _wire(t, group)
    dist.broadcast(wire, dist.get_global_rank(group, src), group=group)
    return _back(t, wire)


def send(t: torch.Tensor, dst: int, group) -> None:
    """Send ``t`` to group rank ``dst``."""
    dist.send(_wire(t, group), dist.get_global_rank(group, dst),
              group=group)


def recv(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Receive into ``t`` from group rank ``src``; returns ``t``."""
    wire = _wire(t, group)
    dist.recv(wire, dist.get_global_rank(group, src), group=group)
    return _back(t, wire)


def same_on_all(flag: bool, group) -> bool:
    """``flag`` where every rank of ``group`` holds it (a MIN reduce), so
    that a loop exits on every rank at the same step."""
    if group_size(group) < 2:
        return flag
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    return bool(all_reduce(t, group, dist.ReduceOp.MIN).item())


def slice_bounds(n: int, group) -> tuple:
    """``[start, stop)`` of this rank's equal share of ``n``."""
    size = group_size(group)
    share = n // size
    r = group_rank(group)
    return r * share, (r + 1) * share


# -- autograd pairs -----------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ScatterLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        lo, hi = slice_bounds(x.shape[-1], group)
        return x[..., lo:hi].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(all_gather(grad.contiguous(), ctx.group),
                         dim=-1), None


def copy_to(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    if group_size(group) < 2 or not torch.is_grad_enabled():
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    if group_size(group) < 2:
        return x
    if not torch.is_grad_enabled():
        return all_reduce(x.contiguous(), group)
    return _ReduceFrom.apply(x, group)


def scatter_last(x: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    if group_size(group) < 2:
        return x
    return _ScatterLast.apply(x, group)
