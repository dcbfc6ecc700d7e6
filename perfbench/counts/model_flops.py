"""Model operations of the vision tower and the captioner, from their
sizes, under the counting rules of ``attention_fwd.py``: a multiply-add
is two operations, and attention counts the visible (query, key) pairs
only, so causal attention counts at its half.  Layer norms, softmax and
elementwise work are left out.  Training counts the backward at twice the
forward.  (Bytes are counted in ``decode_step.py``, each input or output
byte once.)
"""
from __future__ import annotations

from typing import Dict

from . import attention_fwd


def _block_params(width: int, mlp_ratio: int = 4) -> int:
    """qkv, the output projection and the two MLP matrices of a block."""
    return (4 + 2 * mlp_ratio) * width * width


def vit_forward(sizes: Dict, frames: int) -> int:
    w, p = sizes["width"], sizes["patch_size"]
    n = (sizes["image_size"] // p) ** 2 + 1
    per_frame = (2 * p * p * 3 * w * (n - 1)
                 + sizes["layers"] * (2 * _block_params(w, sizes["mlp_ratio"])
                                      * n + 4 * w * n * n)
                 + 2 * w * sizes["embed_dim"])
    return frames * per_frame


def decoder_forward(sizes: Dict, batch: int, tokens: int,
                    logit_rows: int) -> int:
    """A full-sequence forward over the nv vision slots and ``tokens``
    token positions, with the head at ``logit_rows`` positions a row."""
    d, nv = sizes["width"], sizes["num_vision_tokens"]
    t = nv + tokens
    heads = sizes["heads"]
    mm = (2 * sizes["layers"] * _block_params(d) * t
          + 2 * d * sizes["vocab"] * logit_rows
          + 2 * sizes["vision_dim"] * d * nv)
    attn = sizes["layers"] * attention_fwd.ops(1, heads, t, d // heads, nv)
    return batch * (mm + attn)


def decoder_train(sizes: Dict, batch: int, tokens: int) -> int:
    """Forward and backward of a training step (logits at every token)."""
    return 3 * decoder_forward(sizes, batch, tokens, tokens)


def decode_step(sizes: Dict, batch: int, slots: int) -> int:
    """One cached decode step of ``batch`` rows over ``slots`` slots."""
    d = sizes["width"]
    return batch * (2 * sizes["layers"] * _block_params(d)
                    + 2 * d * sizes["vocab"]
                    + sizes["layers"] * 4 * d * slots)
