"""Plain reference of the byte-level captioner: embeddings, pre-norm
transformer blocks with a vision prefix, and the byte head.

It follows the published decoder of the port's ``CaptionerConfig``
presets (``vidgraph_tpu_torch/models/captioner.py``), written again from
its equations in float32 and with no kernel, cache or batching:

    x = [vision_emb @ vis_proj_w + vis_proj_b ; tok_emb[tokens]] + pos_emb
    per block: x += attn_o(attention(qkv(ln1(x))));  x += fc2(gelu(fc1(ln2(x))))
    logits = ln_f(x) @ head_w          (token positions only)

Layer norms take eps 1e-5; GELU is the tanh form; attention scales by
1/sqrt(hd), and key ``c`` is visible to query ``r`` iff
``c <= max(r, nv - 1)`` (the nv vision slots see each other, the rest is
causal).  ``rnd`` rounds every product's operands (``lowp.py``).

The weights are drawn from the seed by the frozen threefry copy
(``prng.py``), in the order the port's ``init_params`` draws them:
``split(PRNGKey(seed), 8 + 8 layers)`` taken in turn by tok_emb, pos_emb,
vis_proj_w, head_w and each block's qkv_w, attn_o_w, fc1_w, fc2_w, as
N(0, 1) x 0.02 rounded to the configuration's parameter type; biases
zero, layer-norm scales one.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from . import prng
from .lowp import exact

Round = Callable[[torch.Tensor], torch.Tensor]
_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init_params(sizes: Dict, seed: int, param_dtype: str,
                device, requires_grad: bool = False) -> Dict:
    """The seeded weights as float32 tensors holding values of
    ``param_dtype``; ``requires_grad`` marks every leaf."""
    layers, d = sizes["layers"], sizes["width"]
    v = sizes["vocab"]
    keys = iter(prng.split(prng.PRNGKey(seed), 8 + layers * 8))
    kind = _TYPES[param_dtype]

    def dense(*shape):
        w = prng.normal(next(keys), shape, device=device) * 0.02
        return w.to(kind).float()

    def full(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=device)

    p: Dict = {"tok_emb": dense(v, d),
               "pos_emb": dense(sizes["max_len"], d),
               "vis_proj_w": dense(sizes["vision_dim"], d),
               "vis_proj_b": full(d, 0.0),
               "ln_f_scale": full(d, 1.0), "ln_f_bias": full(d, 0.0),
               "head_w": dense(d, v), "blocks": []}
    for _ in range(layers):
        p["blocks"].append({
            "ln1_scale": full(d, 1.0), "ln1_bias": full(d, 0.0),
            "qkv_w": dense(d, 3 * d), "qkv_b": full(3 * d, 0.0),
            "attn_o_w": dense(d, d), "attn_o_b": full(d, 0.0),
            "ln2_scale": full(d, 1.0), "ln2_bias": full(d, 0.0),
            "fc1_w": dense(d, 4 * d), "fc1_b": full(4 * d, 0.0),
            "fc2_w": dense(4 * d, d), "fc2_b": full(d, 0.0)})
    if requires_grad:
        for leaf in leaves(p).values():
            leaf.requires_grad_(True)
    return p


def leaves(params: Dict) -> Dict[str, torch.Tensor]:
    """Every tensor of the tree by its path (``blocks/3/qkv_w``)."""
    out = {k: t for k, t in params.items() if k != "blocks"}
    for i, bp in enumerate(params["blocks"]):
        out.update({f"blocks/{i}/{k}": t for k, t in bp.items()})
    return out


def _mm(x, w, rnd: Round):
    return rnd(x) @ rnd(w)


def _ln(x, scale, bias):
    return F.layer_norm(x, x.shape[-1:], scale, bias, 1e-5)


def visible(t: int, nv: int, device) -> torch.Tensor:
    """[t, t] bool: key c visible to query r iff c <= max(r, nv - 1)."""
    r = torch.arange(t, device=device)[:, None]
    c = torch.arange(t, device=device)[None, :]
    return c <= torch.clamp(r, min=nv - 1)


def block(bp: Dict, heads: int, nv: int, x: torch.Tensor,
          rnd: Round = exact) -> torch.Tensor:
    b, t, d = x.shape
    hd = d // heads
    qkv = _mm(_ln(x, bp["ln1_scale"], bp["ln1_bias"]), bp["qkv_w"], rnd) \
        + bp["qkv_b"]
    q, k, v = (z.reshape(b, t, heads, hd).transpose(1, 2)
               for z in qkv.split(d, dim=-1))
    s = _mm(q, k.transpose(-1, -2), rnd) / math.sqrt(hd)
    s = s.masked_fill(~visible(t, nv, x.device), float("-inf"))
    o = _mm(torch.softmax(s, dim=-1), v, rnd)
    o = o.transpose(1, 2).reshape(b, t, d)
    x = x + _mm(o, bp["attn_o_w"], rnd) + bp["attn_o_b"]
    h = _mm(_ln(x, bp["ln2_scale"], bp["ln2_bias"]), bp["fc1_w"], rnd) \
        + bp["fc1_b"]
    h = F.gelu(h, approximate="tanh")
    return x + _mm(h, bp["fc2_w"], rnd) + bp["fc2_b"]


def forward(params: Dict, sizes: Dict, vision_emb: torch.Tensor,
            tokens: torch.Tensor, rnd: Round = exact,
            block_fn: Optional[Callable] = None) -> torch.Tensor:
    """Logits [B, T, vocab] float32 at the token positions of
    ``vision_emb`` [B, nv, vision_dim] followed by ``tokens`` [B, T].
    ``block_fn(fn, x)`` may wrap each block (checkpointing)."""
    nv, heads = sizes["num_vision_tokens"], sizes["heads"]
    prefix = _mm(vision_emb, params["vis_proj_w"], rnd) + params["vis_proj_b"]
    x = torch.cat([prefix, params["tok_emb"][tokens.long()]], dim=1)
    x = x + params["pos_emb"][:x.shape[1]][None]
    for bp in params["blocks"]:
        fn = (lambda x_, bp_=bp: block(bp_, heads, nv, x_, rnd))
        x = fn(x) if block_fn is None else block_fn(fn, x)
    x = _ln(x[:, nv:], params["ln_f_scale"], params["ln_f_bias"])
    return _mm(x, params["head_w"], rnd)

