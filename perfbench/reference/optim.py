"""Plain reference of one training step's loss and update, from optax's
definitions, in float32:

* the loss: the mean over the response span of the next-byte cross
  entropy, the span being the positions from the last prompt byte on whose
  target is not padding;
* ``clip_by_global_norm(max_norm)``: every gradient times
  ``max_norm / norm`` when the global l2 norm exceeds ``max_norm``;
* ``adamw(lr, b1 0.9, b2 0.999, eps 1e-8, weight_decay)``:
  ``p -= lr (m_hat / (sqrt(v_hat) + eps) + weight_decay p)``;
* ``warmup_cosine_decay_schedule(0, peak, warmup, decay, end)``.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

B1, B2, EPS = 0.9, 0.999, 1e-8


def response_mask(targets: torch.Tensor, prompt_lens: torch.Tensor,
                  pad_id: int) -> torch.Tensor:
    pos = torch.arange(targets.shape[1], device=targets.device)[None]
    return (pos >= prompt_lens[:, None] - 1) & (targets != pad_id)


def ce_sum(logits: torch.Tensor, targets: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """Sum of the cross entropy over ``mask``."""
    ce = F.cross_entropy(logits.flatten(0, 1), targets.flatten().long(),
                         reduction="none")
    return (ce * mask.flatten().float()).sum()


def lr_at(count: int, peak: float, warmup: int, decay: int,
          end: float) -> float:
    if count < warmup:
        return peak * count / warmup
    frac = min(count - warmup, decay - warmup) / (decay - warmup)
    return end + (peak - end) * 0.5 * (1.0 + math.cos(math.pi * frac))


def clip(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    factor = max_norm / norm if norm > max_norm else 1.0
    return [g * factor for g in grads]


class AdamW:
    """optax's adamw over a dict of float32 leaves, updated in place."""

    def __init__(self, leaves: Dict[str, torch.Tensor],
                 weight_decay: float) -> None:
        self.leaves = leaves
        self.wd = weight_decay
        self.m = {k: torch.zeros_like(p) for k, p in leaves.items()}
        self.v = {k: torch.zeros_like(p) for k, p in leaves.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        t = self.count + 1
        for k, p in self.leaves.items():
            g = grads[k]
            self.m[k].mul_(B1).add_(g, alpha=1 - B1)
            self.v[k].mul_(B2).addcmul_(g, g, value=1 - B2)
            m_hat = self.m[k] / (1 - B1 ** t)
            v_hat = self.v[k] / (1 - B2 ** t)
            p.sub_(lr * (m_hat / (v_hat.sqrt() + EPS) + self.wd * p))
        self.count = t
