"""int8 inference path of the ViT tower.

Counterpart of ``vidgraph_tpu/models/vit_quant.py``, which the JAX package
keeps for the record and wires into no backend; the same holds here.  It
takes the tower's parameter tree (``models/vit.py::param_tree``, the Flax
layout): every Dense kernel is quantised once (symmetric int8, one scale
per output channel), the activations per row at every product, the sums
are exact int32 and the rescale float32 (``models/quant8.py::a8_dot``, the
product ``wdot`` uses in mode ``a8``); attention scores, softmax and
context stay as in the float tower.  Whether int8 pays for this tower on
the H100 has not been measured.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..ops.preprocess import patchify
from .quant8 import a8_dot, quantize_matrix
from .vit import ViTConfig


def quantize_vit_params(params: Dict[str, Any], cfg: ViTConfig) -> Dict:
    """Quantise every Dense kernel of the tower's tree once: ``_q`` maps a
    layer's name to (int8 kernel, float32 scale, float32 bias), ``_f32``
    holds the layer norms, ``cls`` and ``pos``."""
    p = params["params"]
    out: Dict[str, Any] = {"_f32": {}, "_q": {}}

    def add_dense(name, node):
        w = quantize_matrix(node["kernel"])
        out["_q"][name] = (w.q, w.s, node["bias"].float())

    add_dense("patch_embed", p["patch_embed"])
    add_dense("proj", p["proj"])
    for i in range(cfg.layers):
        blk = p[f"block_{i}"]
        add_dense(f"b{i}/qkv", blk["attn"]["qkv"])
        add_dense(f"b{i}/proj", blk["attn"]["proj"])
        add_dense(f"b{i}/fc1", blk["fc1"])
        add_dense(f"b{i}/fc2", blk["fc2"])
        for ln in ("ln1", "ln2"):
            out["_f32"][f"b{i}/{ln}"] = (blk[ln]["scale"].float(),
                                         blk[ln]["bias"].float())
    out["_f32"]["ln_post"] = (p["ln_post"]["scale"].float(),
                              p["ln_post"]["bias"].float())
    out["_f32"]["cls"] = p["cls"].float()
    out["_f32"]["pos"] = p["pos"].float()
    return out


def _qdense(qp, name: str, x: torch.Tensor) -> torch.Tensor:
    """Per-row int8 activations -> int8 product -> rescale, plus bias."""
    wq, ws, b = qp["_q"][name]
    return a8_dot(x, wq, ws) + b


def _ln(x, scale, bias):
    return F.layer_norm(x, x.shape[-1:], scale, bias, 1e-6)


@torch.no_grad()
def vit_forward_int8(qp: Dict, cfg: ViTConfig,
                     images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (pre-processed floats) -> [B, embed_dim]
    float32, unit norm."""
    b = images.shape[0]
    x = _qdense(qp, "patch_embed", patchify(images.float(), cfg.patch_size))
    cls = qp["_f32"]["cls"].expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + qp["_f32"]["pos"]
    h, hd = cfg.heads, cfg.width // cfg.heads
    n = x.shape[1]
    for i in range(cfg.layers):
        qkv = _qdense(qp, f"b{i}/qkv", _ln(x, *qp["_f32"][f"b{i}/ln1"]))
        q, k, v = (z.reshape(b, n, h, hd).to(torch.bfloat16).float()
                   for z in qkv.split(cfg.width, dim=-1))
        att = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        att = torch.softmax(att, dim=-1).to(torch.bfloat16).float()
        o = torch.einsum("bhqk,bkhd->bqhd", att, v)
        x = x + _qdense(qp, f"b{i}/proj", o.reshape(b, n, cfg.width))
        y = _ln(x, *qp["_f32"][f"b{i}/ln2"])
        x = x + _qdense(qp, f"b{i}/fc2", F.gelu(
            _qdense(qp, f"b{i}/fc1", y), approximate="tanh"))
    out = _qdense(qp, "proj", _ln(x[:, 0], *qp["_f32"]["ln_post"]))
    return out / torch.clamp(
        torch.linalg.vector_norm(out, dim=-1, keepdim=True), min=1e-8)
