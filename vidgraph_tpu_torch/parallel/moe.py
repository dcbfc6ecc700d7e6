"""Expert parallelism: a mixture-of-experts FFN with experts sharded over
the mesh "expert" axis.

Counterpart of ``vidgraph_tpu/parallel/moe.py``: top-1 token routing with
dense dispatch (every expert sees the whole token buffer through a one-hot
combine).  ``place_experts`` keeps this rank's ``E / D`` experts of
``w_in``/``w_out`` (the router stays whole); ``moe_ffn`` on such a tree
runs the local experts over every token, and the combine is the
all-reduce over "expert" that XLA inserts as a psum in the JAX package.
The all-reduce and the input's gradient are autograd pairs
(``parallel/comm.py``), so the sharded FFN trains like the whole one.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from ..core import prng
from . import comm
from .mesh import active_group, axis_group, axis_rank, placements

EXPERT_AXIS = "expert"


def init_moe_params(key, d_model: int, d_hidden: int, n_experts: int,
                    device: Optional[torch.device] = None
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``init_moe_params(key, ...)``: ``key`` (a
    ``core/prng.py`` key) split three ways, N(0, 1) x 0.02 router [D, E],
    ``w_in`` [E, D, H] and ``w_out`` [E, H, D], drawn on ``device`` (the
    CPU when None)."""
    k1, k2, k3 = prng.split(key, 3)
    return {"router_w": prng.normal(k1, (d_model, n_experts),
                                    device=device) * 0.02,
            "w_in": prng.normal(k2, (n_experts, d_model, d_hidden),
                                device=device) * 0.02,
            "w_out": prng.normal(k3, (n_experts, d_hidden, d_model),
                                 device=device) * 0.02}


def moe_params_from_jax(tree: Mapping[str, Any],
                        device: Optional[torch.device] = None
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``init_moe_params`` tree (numpy leaves) as
    float32 tensors, bit for bit."""
    import numpy as np

    return {k: torch.from_numpy(np.array(tree[k], np.float32)).to(device)
            for k in ("router_w", "w_in", "w_out")}


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor
            ) -> torch.Tensor:
    """x [B, T, D] -> [B, T, D]; top-1 routing, dense dispatch.  With
    ``place_experts``' slices the local experts run and their outputs
    are all-reduced over "expert"."""
    logits = x @ params["router_w"]                       # [B, T, E]
    probs = torch.softmax(logits, dim=-1)
    top = torch.argmax(probs, dim=-1)                     # [B, T]
    n_experts = params["router_w"].shape[-1]
    gate = torch.gather(probs, -1, top[..., None])        # [B, T, 1]
    onehot = F.one_hot(top, n_experts).to(x.dtype)        # [B, T, E]
    local = params["w_in"].shape[0]
    group = None
    xe = x
    if local < n_experts:
        group = active_group(EXPERT_AXIS, "experts")
        first = comm.group_rank(group) * local
        onehot = onehot[..., first:first + local]
        xe = comm.copy_to(x, group)
    h = torch.einsum("btd,edh->bteh", xe, params["w_in"])
    h = F.gelu(h, approximate="tanh")
    y = torch.einsum("bteh,ehd->bted", h, params["w_out"])
    out = torch.einsum("bted,bte->btd", y, onehot)
    if group is not None:
        out = comm.reduce_from(out, group)
    return out * gate


def expert_shardings(mesh) -> Dict[str, tuple]:
    return {"router_w": placements(mesh),
            "w_in": placements(mesh, EXPERT_AXIS, None, None),
            "w_out": placements(mesh, EXPERT_AXIS, None, None)}


def place_experts(params: Dict[str, torch.Tensor], mesh
                  ) -> Dict[str, torch.Tensor]:
    """This rank's experts of ``w_in``/``w_out`` (new leaves,
    ``requires_grad`` kept) and the whole router."""
    group = axis_group(mesh, EXPERT_AXIS)
    n = comm.group_size(group)
    r = axis_rank(mesh, EXPERT_AXIS)

    def mine(w):
        part = w.detach().chunk(n, dim=0)[r].clone()
        return part.requires_grad_(w.requires_grad)

    return {"router_w": params["router_w"], "w_in": mine(params["w_in"]),
            "w_out": mine(params["w_out"])}
