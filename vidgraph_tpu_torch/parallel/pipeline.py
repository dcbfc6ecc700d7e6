"""Pipeline parallelism for transformer block stacks (GPipe schedule).

Counterpart of ``vidgraph_tpu/parallel/pipeline.py``.  The L stacked
blocks are divided over the mesh "pipe" axis (stage s holds blocks
``[s L/S, (s+1) L/S)``); the batch is cut into M microbatches that stream
through the stages, with ``send``/``recv`` between neighbouring ranks
where JAX uses ``ppermute``.  Stage s runs microbatch ``m`` at step
``m + s``: the classic S-1 bubble.  The last stage's outputs are
broadcast to every stage, so the output is replicated as JAX's final
``psum`` makes it.

The backward is GPipe's: each stage keeps its microbatches' inputs, and
``backward`` recomputes its blocks on them, takes the output gradients
from the next stage (microbatch by microbatch, in order), and sends the
input gradients to the previous one.  Every stage calls the same
collectives in the same order, so no schedule can deadlock.  The stacked
parameters enter whole on every rank (as JAX's shard_map takes them);
their gradient is all-reduced over "pipe", so every rank holds the whole
gradient, and the input's gradient is broadcast from stage 0.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch

from . import comm
from .mesh import axis_group, axis_rank, axis_size

PIPE_AXIS = "pipe"


def stack_block_params(blocks: List[Dict]) -> Dict:
    """List of per-block param dicts -> one dict with leading dim L."""
    return {k: torch.stack([bp[k] for bp in blocks]) for k in blocks[0]}


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block_fn, keys, group, n_stages, stage, n_micro, x,
                *leaves):
        per = leaves[0].shape[0] // n_stages
        local = {k: v[stage * per:(stage + 1) * per]
                 for k, v in zip(keys, leaves)}
        micro = x.reshape((n_micro, -1) + x.shape[1:])
        inputs, outputs = [], torch.empty_like(micro)
        for m in range(n_micro):
            if stage == 0:
                h = micro[m]
            else:
                h = comm.recv(torch.empty_like(micro[m]), stage - 1, group)
            inputs.append(h)
            out = _stage_apply(block_fn, local, h, per)
            if stage < n_stages - 1:
                comm.send(out, stage + 1, group)
            else:
                outputs[m] = out
        comm.broadcast(outputs, n_stages - 1, group)
        ctx.block_fn, ctx.keys, ctx.group = block_fn, keys, group
        ctx.n_stages, ctx.stage, ctx.per = n_stages, stage, per
        ctx.save_for_backward(*inputs, *leaves)
        ctx.n_micro = n_micro
        return outputs.reshape(x.shape)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        inputs, leaves = saved[:ctx.n_micro], saved[ctx.n_micro:]
        stage, n_stages, per, group = (ctx.stage, ctx.n_stages, ctx.per,
                                       ctx.group)
        grad_micro = grad.reshape((ctx.n_micro, -1) + grad.shape[1:])
        local = [v[stage * per:(stage + 1) * per].detach()
                 .requires_grad_(True) for v in leaves]
        local_grads = [torch.zeros_like(v) for v in local]
        grad_x = torch.zeros_like(grad_micro)
        for m in range(ctx.n_micro):
            if stage == n_stages - 1:
                g_out = grad_micro[m]
            else:
                g_out = comm.recv(torch.empty_like(grad_micro[m]),
                                  stage + 1, group)
            h = inputs[m].detach().requires_grad_(True)
            with torch.enable_grad():
                out = _stage_apply(ctx.block_fn, dict(zip(ctx.keys, local)),
                                   h, per)
                got = torch.autograd.grad(out, [h, *local], g_out,
                                          allow_unused=True)
            for acc, g in zip(local_grads, got[1:]):
                if g is not None:
                    acc += g
            if stage > 0:
                comm.send(got[0], stage - 1, group)
            else:
                grad_x[m] = got[0]
        comm.broadcast(grad_x, 0, group)
        leaf_grads = []
        for v, g in zip(leaves, local_grads):
            full = torch.zeros_like(v)
            full[stage * per:(stage + 1) * per] = g
            leaf_grads.append(comm.all_reduce(full, group))
        return (None, None, None, None, None, None,
                grad_x.reshape(grad.shape), *leaf_grads)


def _stage_apply(block_fn, local: Dict[str, torch.Tensor], h: torch.Tensor,
                 per: int) -> torch.Tensor:
    for i in range(per):
        h = block_fn({k: v[i] for k, v in local.items()}, h)
    return h


def pipeline_forward(block_fn: Callable[[Dict, torch.Tensor], torch.Tensor],
                     stacked_params: Dict, x: torch.Tensor, mesh,
                     n_microbatches: int,
                     axis: str = PIPE_AXIS) -> torch.Tensor:
    """Run ``x [B, ...]`` through all L stacked blocks, pipelined over the
    mesh ``axis``.  B must divide by n_microbatches; L by the axis size.
    Every rank of the axis calls it with the same arguments."""
    n_stages = axis_size(mesh, axis)
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} % microbatches {n_microbatches}")
    keys = list(stacked_params)
    leaves = [stacked_params[k] for k in keys]
    leading = leaves[0].shape[0]
    if leading % n_stages:
        raise ValueError(f"blocks {leading} % stages {n_stages}")
    return _GPipe.apply(block_fn, keys, axis_group(mesh, axis), n_stages,
                        axis_rank(mesh, axis), n_microbatches, x, *leaves)


def captioner_block_fn(cfg, mask: torch.Tensor
                       ) -> Callable[[Dict, torch.Tensor], torch.Tensor]:
    """Adapter: the captioner's full-sequence block as a pipeline stage
    body (the additive [T, T] mask closed over; bp leaves have no
    leading block dim)."""
    from ..models.captioner import _block

    def fn(bp: Dict, x: torch.Tensor) -> torch.Tensor:
        return _block(bp, cfg, x, mask=mask)[0]

    return fn
