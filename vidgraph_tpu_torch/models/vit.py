"""Vision tower: the CLIP-style ViT, as ``torch.nn`` modules.

Counterpart of ``vidgraph_tpu/models/vit.py`` (Flax).  The modules and
parameters carry the Flax names (``block_0.attn.qkv.kernel``,
``ln_post.scale``, ``cls``, ``pos``), and ``Dense`` keeps Flax's [in, out]
kernel, so a Flax tree crosses by renaming alone (``param_tree``,
``state_dict_from_tree``, ``convert.vit_params_from_jax``).

Numerics follow the Flax modules with ``dtype`` the compute dtype and
float32 parameters:
* ``Dense``: input and kernel cast to the compute dtype, the product in
  it (float32 accumulation, one rounding), then the bias added in it;
* ``LayerNorm``: statistics in float32, eps 1e-6, the result cast to the
  compute dtype (the captioner's ``_ln`` uses 1e-5);
* the residual stream is in the compute dtype; GELU is the tanh form;
* attention scores are float32 divided by ``sqrt(hd)``, the softmax
  float32, the probabilities cast to the compute dtype, P.V summed in
  float32;
* the output is ``proj`` of the class token in float32, times
  ``rsqrt(sum(x^2) + 1e-12)``.

``attn_impl`` picks the attention: ``einsum`` (the reference path),
``packed`` (head-pair packing) or ``fused`` (``ops/short_attention.py``:
the CUDA kernel on the card).  An odd head count takes ``einsum``.  The
products (patch embedding, qkv, proj, fc1, fc2) are ``torch.matmul``, as
the JAX package leaves them to XLA.

Tensor parallelism: ``param_shardings`` gives the JAX package's specs as
placements (qkv/fc1 kernels column-split, proj/fc2 kernels row-split over
"model", the rest replicated), and ``shard_tower`` keeps this rank's
slices in the tower's ``Dense`` layers (``Dense.split``): a column layer
keeps its bias's slice too, where GSPMD slices the replicated bias on use;
a layer whose width the model axis does not divide stays whole.  Inside
``parallel.mesh.use_mesh`` the attention runs the local heads, and each
row layer all-reduces its float32 partial sums over "model" before its
bias; the final ``proj`` takes its slice of the class token's columns.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core import prng
from ..ops.preprocess import patchify
from ..ops.short_attention import fused_short_attention, packed_attention
from ..parallel import comm
from ..parallel import tensor_parallel as tp
from ..parallel.mesh import (MODEL_AXIS, active_group, axis_group,
                             placements)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    embed_dim: int = 512          # output projection dim
    mlp_ratio: int = 4
    dtype: Any = torch.bfloat16   # compute dtype
    attn_impl: str = "einsum"     # einsum | packed | fused

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def b32(cls) -> "ViTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ViTConfig":
        """Small config for CPU tests."""
        return cls(image_size=64, patch_size=32, width=64, layers=2,
                   heads=2, embed_dim=32, dtype=torch.float32)


class Dense(nn.Module):
    """Flax ``nn.Dense(dtype=...)``: kernel [in, out], bias [out].
    ``split`` is None, ``"cols"`` (this rank's output columns) or
    ``"rows"`` (its input rows; the partial sums are all-reduced)."""

    def __init__(self, d_in: int, d_out: int, dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.split: Optional[str] = None
        self.kernel = nn.Parameter(torch.empty(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.split is None:
            y = torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
            return y + self.bias.to(self.dtype)
        group = active_group(MODEL_AXIS, "ViT weights")
        if self.split == "cols":
            y = torch.matmul(comm.copy_to(x, group).to(self.dtype),
                             self.kernel.to(self.dtype))
            return y + self.bias.to(self.dtype)
        if x.shape[-1] != self.kernel.shape[0]:
            x = comm.scatter_last(x, group)
        part = x.to(self.dtype).float() @ self.kernel.to(self.dtype).float()
        return comm.reduce_from(part, group).to(self.dtype) \
            + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=...)``: float32 statistics, eps 1e-6."""

    def __init__(self, d: int, dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.scale, self.bias,
                            1e-6).to(self.dtype)


class MHA(nn.Module):
    def __init__(self, cfg: ViTConfig) -> None:
        super().__init__()
        self.cfg = cfg
        self.qkv = Dense(cfg.width, 3 * cfg.width, cfg.dtype)
        self.proj = Dense(cfg.width, cfg.width, cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        hd = c.width // c.heads
        b, n, _ = x.shape
        qkv = self.qkv(x)
        width = qkv.shape[-1] // 3
        heads = width // hd                  # the rank's local heads
        q, k, v = (z.reshape(b, n, heads, hd)
                   for z in qkv.split(width, dim=-1))
        impl = c.attn_impl if heads % 2 == 0 else "einsum"
        if impl in ("packed", "fused"):
            qh, kh, vh = (z.transpose(1, 2) for z in (q, k, v))
            if impl == "fused":
                oh = fused_short_attention(qh, kh, vh)
            else:
                oh = packed_attention(qh, kh, vh)
            out = oh.transpose(1, 2)
        elif impl == "einsum":
            att = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            att = att / math.sqrt(hd)
            att = torch.softmax(att, dim=-1).to(c.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", att.float(), v.float())
        else:
            raise ValueError(f"attn_impl must be einsum|packed|fused, got "
                             f"{c.attn_impl!r}")
        return self.proj(out.reshape(b, n, width).to(c.dtype))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig) -> None:
        super().__init__()
        w = cfg.width
        self.ln1 = LayerNorm(w, cfg.dtype)
        self.attn = MHA(cfg)
        self.ln2 = LayerNorm(w, cfg.dtype)
        self.fc1 = Dense(w, w * cfg.mlp_ratio, cfg.dtype)
        self.fc2 = Dense(w * cfg.mlp_ratio, w, cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class VisionTower(nn.Module):
    """images [B, H, W, 3] (normalised) -> embeddings [B, embed_dim]
    float32, unit norm; or, with ``return_tokens``, every token's
    projection [B, N + 1, embed_dim] in the compute dtype."""

    def __init__(self, cfg: ViTConfig) -> None:
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.patch_embed = Dense(cfg.patch_size ** 2 * 3, w, cfg.dtype)
        self.cls = nn.Parameter(torch.zeros(1, 1, w))
        self.pos = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, w))
        for i in range(cfg.layers):
            self.add_module(f"block_{i}", Block(cfg))
        self.ln_post = LayerNorm(w, cfg.dtype)
        self.proj = Dense(w, cfg.embed_dim, cfg.dtype)

    def forward(self, images: torch.Tensor,
                return_tokens: bool = False) -> torch.Tensor:
        c = self.cfg
        x = self.patch_embed(patchify(images, c.patch_size).to(c.dtype))
        b = x.shape[0]
        cls = self.cls.to(c.dtype).expand(b, 1, c.width)
        x = torch.cat([cls, x], dim=1) + self.pos.to(c.dtype)
        for i in range(c.layers):
            x = getattr(self, f"block_{i}")(x)
        x = self.ln_post(x)
        if return_tokens:
            return self.proj(x)
        out = self.proj(x[:, 0]).float()
        return out * torch.rsqrt((out * out).sum(dim=-1, keepdim=True)
                                 + 1e-12)


# the counter (from 1) Flax's ``make_rng`` gives each parameter in its
# scope: Dense creates its kernel before its bias, LayerNorm its scale
# before its bias, the tower ``cls`` before ``pos``
_FLAX_COUNTER = {"kernel": 1, "scale": 1, "bias": 2, "cls": 1, "pos": 2}


def init_vision_tower(cfg: ViTConfig, seed: int = 0,
                      device: Optional[torch.device] = None) -> VisionTower:
    """The tower the JAX package's ``init_vision_tower(cfg, seed)`` makes
    (Flax's ``VisionTower(cfg).init(PRNGKey(seed), ...)``), float32
    parameters drawn on ``device`` (the CPU when None) by ``core/prng.py``
    from the key Flax derives for each one (``prng.flax_key`` over the
    parameter's Flax path): kernels lecun_normal (a normal truncated to
    two standard deviations, over sqrt(fan_in)), ``cls`` and ``pos``
    N(0, 1) x 0.02, biases zero, layer-norm scales one."""
    root = prng.PRNGKey(seed)
    with torch.device(device if device is not None else "cpu"):
        tower = VisionTower(cfg)
    with torch.no_grad():
        for name, p in tower.named_parameters():
            *path, leaf = name.split(".")
            key = prng.flax_key(root, path, _FLAX_COUNTER[leaf])
            if leaf == "kernel":
                p.copy_(prng.lecun_normal(key, p.shape, device=p.device))
            elif leaf in ("cls", "pos"):
                p.copy_(prng.normal(key, p.shape, device=p.device) * 0.02)
            else:
                p.fill_(1.0 if leaf == "scale" else 0.0)
    return tower


def param_tree(tower: VisionTower) -> Dict[str, Any]:
    """The tower's parameters as the Flax tree ``{"params": {...}}``
    (nested dicts of tensors; the leaves are the parameters' data)."""
    tree: Dict[str, Any] = {}
    for name, p in tower.named_parameters():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach()
    return {"params": tree}


def state_dict_from_tree(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A Flax tree ``{"params": {...}}`` (leaves as tensors) flattened to
    the tower's ``state_dict`` keys."""
    flat: Dict[str, Any] = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}.{key}" if prefix else str(key)
            if isinstance(val, Mapping):
                walk(val, name)
            else:
                flat[name] = val
    walk(tree["params"], "")
    return flat


def _split_of(path: str) -> Optional[str]:
    """The JAX package's rule (``vidgraph_tpu/models/vit.py::
    param_shardings``) for a 2-D kernel at ``path``."""
    if any(k in path for k in ("qkv", "fc1")):
        return "cols"
    if any(k in path for k in ("proj", "fc2")):
        return "rows"
    return None


def param_shardings(params: Mapping[str, Any], mesh) -> Dict[str, Any]:
    """Tensor-parallel placements of a Flax-format tree (``param_tree``),
    leaf for leaf: qkv/fc1 kernels column-split, proj/fc2 kernels
    row-split on "model", every other leaf replicated."""
    def walk(node, prefix):
        out = {}
        for key, val in node.items():
            path = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(val, Mapping):
                out[key] = walk(val, path)
                continue
            split = _split_of(path) if val.dim() == 2 else None
            out[key] = (placements(mesh, None, MODEL_AXIS)
                        if split == "cols" else
                        placements(mesh, MODEL_AXIS, None)
                        if split == "rows" else placements(mesh))
        return out
    return walk(params, "")


def _split_layers(tower: "VisionTower", group):
    """(module, split, parts) for every Dense the model axis shards:
    attention when it divides the heads, the MLP when it divides the
    hidden width, the output projection when it divides the width."""
    c = tower.cfg
    heads_ok = tp.divides(c.heads, group)
    for name, mod in tower.named_modules():
        if not isinstance(mod, Dense):
            continue
        split = _split_of(name.replace(".", "/") + "/kernel")
        if split is None:
            continue
        if name.endswith(("attn.qkv", "attn.proj")):
            ok = heads_ok
        elif name.endswith(("fc1", "fc2")):
            ok = tp.divides(c.width * c.mlp_ratio, group)
        else:
            ok = tp.divides(c.width, group)
        if ok:
            yield mod, split, 3 if name.endswith("qkv") else 1


def shard_tower(tower: "VisionTower", mesh) -> "VisionTower":
    """Keep this rank's slices in the tower's tensor-parallel layers, in
    place (new leaf parameters, ``requires_grad`` kept); returns it."""
    group = axis_group(mesh, MODEL_AXIS)
    if group is None:
        return tower
    for mod, split, parts in list(_split_layers(tower, group)):
        with torch.no_grad():
            if split == "cols":
                kernel = tp.split_cols(mod.kernel, group, parts)
                bias = tp.split_cols(mod.bias, group, parts)
            else:
                kernel = tp.split_rows(mod.kernel, group)
                bias = mod.bias.detach().clone()
        grad = mod.kernel.requires_grad
        mod.kernel = nn.Parameter(kernel, requires_grad=grad)
        mod.bias = nn.Parameter(bias, requires_grad=grad)
        mod.split = split
    return tower


def gather_tower_tree(tower: "VisionTower", mesh) -> Dict[str, Any]:
    """The whole Flax-format tree (``param_tree``) of a tower that
    ``shard_tower`` split: every rank of the model axis gets it."""
    group = axis_group(mesh, MODEL_AXIS)
    whole = {}
    for mod, split, parts in _split_layers(tower, group):
        if mod.split is None:
            continue
        if split == "cols":
            whole[mod] = (tp.gather_cols(mod.kernel, group, parts),
                          tp.gather_cols(mod.bias, group, parts))
        else:
            whole[mod] = (tp.gather_rows(mod.kernel, group),
                          mod.bias.detach())
    tree = param_tree(tower)
    for name, mod in tower.named_modules():
        if mod in whole:
            node = tree["params"]
            for key in name.split("."):
                node = node[key]
            node["kernel"], node["bias"] = whole[mod]
    return tree
