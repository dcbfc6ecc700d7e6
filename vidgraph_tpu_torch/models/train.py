"""Training: caption-LM fine-tuning of the flagship stack (ViT vision
tower -> byte-level captioner) on one card, and what the trainer scripts
take from optax.

Counterpart of ``vidgraph_tpu/models/train.py``:

    state = TrainState.create(vit_cfg, cap_cfg, device)
    state, loss = state.step(*state.shard_batch(images, tokens))

The JAX package places the parameters over a device mesh (data-parallel
batches, tensor-parallel weights).  The port trains on one device: a mesh
wider than one raises, and ``captioner_shardings`` waits with the mesh
(ROADMAP slice 9, the multi-device half).

The optimiser is ``torch.optim.AdamW`` with optax's defaults (b1 0.9, b2
0.999, eps 1e-8, decoupled decay on every leaf), which computes optax's
update ``p - lr * wd * p - lr * m_hat / (sqrt(v_hat) + eps)``.  The
parameters are float32 leaves updated in place, where JAX returns new
trees; ``step`` returns the state itself.

``warmup_cosine_decay_schedule``, ``cosine_decay_schedule``,
``clip_by_global_norm`` and ``AdamW`` (the
``optax.chain(clip_by_global_norm(1.0), adamw(schedule, weight_decay))`` of
the trainer scripts over a parameter tree, with its state saved and loaded
as numpy arrays; without ``max_norm`` it is the unclipped ``optax.adamw``)
are the port's plain functions for what the JAX trainer scripts
(``scripts/train_{instruct_lm,midscale,reranker,answer_selector,
text_embedder}.py``) build from optax.  optax's
``softmax_cross_entropy_with_integer_labels(...).mean()`` is
``F.cross_entropy`` in float32.  ``StepClock`` times the steps of a
training loop on the host clock.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .captioner import CaptionerConfig, forward, init_params, trainable
from .checkpoint import tree_leaves
from .tokenizer import PAD_ID
from .vit import ViTConfig, VisionTower, init_vision_tower, param_tree


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Mean over ``mask`` of the next-token cross entropy: logits
    [B, T, vocab] float32, targets [B, T] integers, mask [B, T] bool.
    ``F.cross_entropy`` in float32 is the port of
    ``optax.softmax_cross_entropy_with_integer_labels``; the sum is divided
    by ``max(mask.sum(), 1)``, as the JAX losses do."""
    ce = F.cross_entropy(logits.float().flatten(0, 1),
                         targets.flatten().long(), reduction="none")
    m = mask.flatten().float()
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


def caption_loss(tower: VisionTower, cap_params: Dict,
                 cap_cfg: CaptionerConfig, images: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Masked next-byte cross entropy of captions given frames: the
    tower's embedding of ``images`` [B, S, S, 3] fills every vision slot,
    ``tokens`` [B, L] are right-padded with PAD_ID."""
    emb = tower(images)
    vis = emb[:, None, :].expand(-1, cap_cfg.num_vision_tokens, -1)
    logits = forward(cap_params, cap_cfg, vis, tokens[:, :-1].long())
    targets = tokens[:, 1:]
    return masked_cross_entropy(logits, targets, targets != PAD_ID)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine from the peak to
    ``end_value`` that ends at step ``decay_steps`` (counted from step 0)
    and stays there.  Returns ``step -> learning rate``."""
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError("decay_steps must exceed warmup_steps")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = step / warmup_steps
            return init_value + (peak_value - init_value) * frac
        frac = min(step - warmup_steps, cosine_steps) / cosine_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return end_value + (peak_value - end_value) * cosine
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule``: ``init_value * ((1 - alpha) *
    0.5 * (1 + cos(pi * min(step, decay_steps) / decay_steps)) + alpha)``.
    Returns ``step -> learning rate``."""
    if not decay_steps > 0:
        raise ValueError("decay_steps must be positive")

    def schedule(step: int) -> float:
        frac = min(step, decay_steps) / decay_steps
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return schedule


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``, in place: every gradient times
    ``max_norm / norm`` when the global l2 norm exceeds ``max_norm``, left
    as it is otherwise (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
    norm; optax does not).  Returns the norm before clipping."""
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    factor = torch.where(norm > max_norm, max_norm / norm,
                         torch.ones_like(norm))
    for g in grads:
        g.mul_(factor.to(g.dtype))
    return norm


class AdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(lr,
    weight_decay=...))`` over a parameter tree (nested dicts and lists of
    leaf tensors that require a gradient): ``torch.optim.AdamW`` with
    optax's defaults, the learning rate a float or a schedule
    ``step -> float`` read at optax's count (0 at the first update), and
    the clip applied when ``max_norm`` is given."""

    def __init__(self, params: Any,
                 learning_rate: Union[float, Callable[[int], float]],
                 weight_decay: float = 0.01,
                 max_norm: Optional[float] = None) -> None:
        self.keys, self.leaves = zip(*tree_leaves(params))
        self.learning_rate = learning_rate
        self.max_norm = max_norm
        self.count = 0
        fused = all(p.is_cuda for p in self.leaves)
        self.opt = torch.optim.AdamW(
            list(self.leaves), lr=self._lr(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay, fused=fused)

    def _lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def update(self) -> None:
        """One update from the leaves' ``.grad`` (a leaf without one gets
        a zero gradient, as every leaf of a JAX gradient tree has one)."""
        for p in self.leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.max_norm is not None:
            clip_by_global_norm([p.grad for p in self.leaves], self.max_norm)
        for group in self.opt.param_groups:
            group["lr"] = self._lr(self.count)
        self.opt.step()
        self.count += 1

    def state_tree(self) -> Dict[str, Any]:
        """The optimiser's state as a tree for ``checkpoint.save_params``:
        ``exp_avg`` and ``exp_avg_sq`` per leaf (zeros before the first
        update) and the update count."""
        def moments(name):
            return {k: self.opt.state[p][name] if p in self.opt.state
                    else torch.zeros_like(p)
                    for k, p in zip(self.keys, self.leaves)}
        return {"exp_avg": moments("exp_avg"),
                "exp_avg_sq": moments("exp_avg_sq"),
                "count": torch.tensor(self.count, dtype=torch.int64)}

    def load_state_tree(self, tree: Dict[str, Any]) -> None:
        """Inverse of :meth:`state_tree` (tensors on any device)."""
        self.count = int(tree["count"])
        for k, p in zip(self.keys, self.leaves):
            self.opt.state[p] = {
                "step": torch.tensor(float(self.count), dtype=torch.float32,
                                     device=p.device if self.opt.defaults[
                                         "fused"] else "cpu"),
                "exp_avg": tree["exp_avg"][k].to(p.device, p.dtype).clone(),
                "exp_avg_sq": tree["exp_avg_sq"][k].to(p.device,
                                                       p.dtype).clone()}


class StepClock:
    """Milliseconds a training step on the host clock: ``start`` before
    the first timed step and after work that is not a step (a held-out
    evaluation), ``stop`` before such work and after the last step; the
    device's queue is drained at each of them, so queued steps are charged
    to the steps and not to the evaluation."""

    def __init__(self, device: Any) -> None:
        self.cuda = torch.device(device).type == "cuda"
        self.seconds = 0.0
        self._t: Optional[float] = None

    def _now(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def start(self) -> None:
        self._t = self._now()

    def stop(self) -> None:
        if self._t is not None:
            self.seconds += self._now() - self._t
            self._t = None

    def ms_per_step(self, steps: int) -> float:
        return self.seconds * 1e3 / max(1, steps)


def require_single_device(mesh: Any) -> None:
    """Raise for a mesh wider than one device: ``mesh`` is None, a device
    count, or a sequence of devices."""
    n = 1 if mesh is None else mesh if isinstance(mesh, int) else len(mesh)
    if n > 1:
        raise NotImplementedError(
            f"a training mesh of {n} devices: the port trains on one "
            "device; data- and tensor-parallel TrainState shardings are "
            "ROADMAP slice 9 (the multi-device half)")


@dataclasses.dataclass
class TrainState:
    device: torch.device
    vit: VisionTower
    vit_cfg: ViTConfig
    cap_cfg: CaptionerConfig
    params: Dict
    opt: AdamW

    @classmethod
    def create(cls, vit_cfg: ViTConfig, cap_cfg: CaptionerConfig,
               device: Any = None, learning_rate: float = 1e-4,
               weight_decay: float = 0.01,
               generator: Optional[torch.Generator] = None,
               mesh: Any = None) -> "TrainState":
        """Seed weights for both models on ``device`` (default:
        ``core.platform.device()``) and a fresh optimiser.  ``params`` is
        ``{"vit": {<parameter name>: parameter}, "cap": <captioner
        tree>}`` over the live parameters; ``checkpoint_tree`` gives the
        tree ``TPUVLMClient`` loads."""
        require_single_device(mesh)
        if device is None:
            from ..core.platform import device as default_device

            device = default_device()
        device = torch.device(device)
        gen = generator or torch.Generator().manual_seed(0)
        tower = init_vision_tower(vit_cfg, gen, device=device).train()
        cap = init_params(cap_cfg, gen, device=device, requires_grad=True)
        return cls.from_models(tower, cap, vit_cfg, cap_cfg, learning_rate,
                               weight_decay)

    @classmethod
    def from_models(cls, tower: VisionTower, cap_params: Dict,
                    vit_cfg: ViTConfig, cap_cfg: CaptionerConfig,
                    learning_rate: float = 1e-4,
                    weight_decay: float = 0.01) -> "TrainState":
        """A state over an existing tower and captioner tree (float32
        leaves on one device), which it trains in place."""
        trainable(cap_params)
        vit_tree = {name: p for name, p in tower.named_parameters()}
        for p in vit_tree.values():
            p.requires_grad_(True)
        params = {"vit": vit_tree, "cap": cap_params}
        opt = AdamW(params, learning_rate, weight_decay)
        device = cap_params["tok_emb"].device
        return cls(device=device, vit=tower, vit_cfg=vit_cfg,
                   cap_cfg=cap_cfg, params=params, opt=opt)

    def checkpoint_tree(self) -> Dict[str, Any]:
        """``{"vit": <Flax tree>, "cap": <captioner tree>}`` for
        ``checkpoint.save_params``: the tree ``TPUVLMClient`` loads."""
        return {"vit": param_tree(self.vit), "cap": self.params["cap"]}

    def shard_batch(self, images: np.ndarray, tokens: np.ndarray
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Place a numpy batch on the device: images float32
        [B, S, S, 3], tokens int32 [B, L]."""
        return (torch.as_tensor(np.asarray(images, np.float32),
                                device=self.device),
                torch.as_tensor(np.asarray(tokens, np.int32),
                                device=self.device))

    def step(self, images: torch.Tensor, tokens: torch.Tensor
             ) -> Tuple["TrainState", float]:
        self.opt.zero_grad()
        loss = caption_loss(self.vit, self.params["cap"], self.cap_cfg,
                            images, tokens)
        loss.backward()
        self.opt.update()
        return self, loss.item()

