"""Plain reference of the vision tower, a CLIP ViT (Radford et al. 2021,
arXiv:2103.00020): patch embedding, a class token, learned positions,
pre-norm blocks, the final norm and the projection of the class token to a
unit vector.

    x = [cls ; patches(images) @ patch_embed] + pos
    per block: x += proj(attention(qkv(ln1(x))));  x += fc2(gelu(fc1(ln2(x))))
    out = ln_post(x)[:, 0] @ proj;  out / sqrt(|out|^2 + 1e-12)

In float32 with no kernel: layer norms take eps 1e-6, GELU the tanh form,
attention 1/sqrt(hd) and no mask; a patch is flattened in (row, column,
channel) order, and the patches run row by row.  ``rnd`` rounds every
product's operands (``lowp.py``).

The weights are drawn from the seed by the frozen threefry copy
(``prng.py``) as the port's ``init_vision_tower`` draws them: each
parameter from the key its Flax path gives (``prng.flax_key``), kernels
lecun-normal, ``cls`` and ``pos`` N(0, 1) x 0.02, biases zero, layer-norm
scales one, all float32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import prng
from .lowp import exact

Round = Callable[[torch.Tensor], torch.Tensor]
# the counter Flax's ``make_rng`` gives each parameter in its scope
_COUNTER = {"kernel": 1, "scale": 1, "bias": 2, "cls": 1, "pos": 2}


def shapes(sizes: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every parameter's name (its Flax path, dot-joined) and shape."""
    w, p = sizes["width"], sizes["patch_size"]
    n = (sizes["image_size"] // p) ** 2
    hid = w * sizes["mlp_ratio"]
    out = [("patch_embed.kernel", (p * p * 3, w)), ("patch_embed.bias", (w,)),
           ("cls", (1, 1, w)), ("pos", (1, n + 1, w))]
    for i in range(sizes["layers"]):
        b = f"block_{i}"
        out += [(f"{b}.ln1.scale", (w,)), (f"{b}.ln1.bias", (w,)),
                (f"{b}.attn.qkv.kernel", (w, 3 * w)),
                (f"{b}.attn.qkv.bias", (3 * w,)),
                (f"{b}.attn.proj.kernel", (w, w)),
                (f"{b}.attn.proj.bias", (w,)),
                (f"{b}.ln2.scale", (w,)), (f"{b}.ln2.bias", (w,)),
                (f"{b}.fc1.kernel", (w, hid)), (f"{b}.fc1.bias", (hid,)),
                (f"{b}.fc2.kernel", (hid, w)), (f"{b}.fc2.bias", (w,))]
    return out + [("ln_post.scale", (w,)), ("ln_post.bias", (w,)),
                  ("proj.kernel", (w, sizes["embed_dim"])),
                  ("proj.bias", (sizes["embed_dim"],))]


def init_tower(sizes: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    root = prng.PRNGKey(seed)
    params = {}
    for name, shape in shapes(sizes):
        *path, leaf = name.split(".")
        if leaf in ("scale", "bias"):
            params[name] = torch.full(shape, 1.0 if leaf == "scale" else 0.0,
                                      device=device)
            continue
        key = prng.flax_key(root, path, _COUNTER[leaf])
        if leaf == "kernel":
            params[name] = prng.lecun_normal(key, shape, device=device)
        else:
            params[name] = prng.normal(key, shape, device=device) * 0.02
    return params


def _ln(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.scale"],
                        p[f"{name}.bias"], 1e-6)


def _dense(x, p, name, rnd):
    return rnd(x) @ rnd(p[f"{name}.kernel"]) + p[f"{name}.bias"]


def patches(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)(W/p), p p C]."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, patch * patch * c)


def tower(params: Dict[str, torch.Tensor], sizes: Dict,
          images: torch.Tensor, rnd: Round = exact) -> torch.Tensor:
    """images [B, S, S, 3] (normalised) -> [B, embed_dim] unit vectors."""
    w, heads = sizes["width"], sizes["heads"]
    hd = w // heads
    x = _dense(patches(images.float(), sizes["patch_size"]), params,
               "patch_embed", rnd)
    b, n = x.shape[0], x.shape[1] + 1
    x = torch.cat([params["cls"].expand(b, 1, w), x], dim=1) + params["pos"]
    for i in range(sizes["layers"]):
        blk = f"block_{i}"
        qkv = _dense(_ln(x, params, f"{blk}.ln1"), params, f"{blk}.attn.qkv",
                     rnd)
        q, k, v = (z.reshape(b, n, heads, hd).transpose(1, 2)
                   for z in qkv.split(w, dim=-1))
        s = rnd(q) @ rnd(k.transpose(-1, -2)) / math.sqrt(hd)
        o = (rnd(torch.softmax(s, dim=-1)) @ rnd(v)).transpose(1, 2)
        x = x + _dense(o.reshape(b, n, w), params, f"{blk}.attn.proj", rnd)
        h = F.gelu(_dense(_ln(x, params, f"{blk}.ln2"), params, f"{blk}.fc1",
                          rnd), approximate="tanh")
        x = x + _dense(h, params, f"{blk}.fc2", rnd)
    out = _dense(_ln(x, params, "ln_post")[:, 0], params, "proj", rnd)
    return out * torch.rsqrt((out * out).sum(-1, keepdim=True) + 1e-12)
