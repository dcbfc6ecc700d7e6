"""Training: caption-LM fine-tuning of the flagship stack (ViT vision
tower -> byte-level captioner) on one device or over a (data, model) mesh,
and what the trainer scripts take from optax.

Counterpart of ``vidgraph_tpu/models/train.py``:

    state = TrainState.create(vit_cfg, cap_cfg, device, mesh=mesh)
    state, loss = state.step(*state.shard_batch(images, tokens))

Over a mesh (``parallel/mesh.py``), every rank runs this code (SPMD):
``shard_batch`` keeps the rank's rows of the batch ("data");
``captioner_shardings`` and ``vit.param_shardings`` are the JAX
package's tensor-parallel specs as placements, and the weights hold the
rank's slices of them ("model"; ``shard_captioner``,
``vit.shard_tower``).  The loss is the global masked mean: the masked
cross-entropy sums and the mask counts are all-reduced over "data"
before the division, so ranks with different pad counts weigh each token
alike.  Gradients are all-reduced over "data" (one flat buffer); the
replicated leaves' gradients are already equal along "model", since the
tensor-parallel seams all-reduce the activations' gradients
(``parallel/comm.py``).  ``TrainState`` has no gradient clip, as in the
JAX package.

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

from ..core import profiling
from ..parallel import comm
from ..parallel import tensor_parallel as tp
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, axis_group, axis_rank,
                             axis_size, placements, use_mesh)
from .captioner import (CaptionerConfig, _shape, forward, init_params,
                        trainable)
from .checkpoint import tree_leaves
from .quant8 import is_q8
from .tokenizer import PAD_ID
from .vit import (ViTConfig, VisionTower, gather_tower_tree,
                  init_vision_tower, param_tree, shard_tower)


def captioner_shardings(params: Dict, mesh) -> Dict:
    """Tensor-parallel placements of the captioner tree, leaf for leaf
    (embeddings and LM head replicated: vocab 259 is indivisible by
    usual axis sizes)."""
    rep = placements(mesh)

    def blk(bp):
        return {
            **{k: rep for k in bp},
            "qkv_w": placements(mesh, None, MODEL_AXIS),
            "qkv_b": placements(mesh, MODEL_AXIS),
            "fc1_w": placements(mesh, None, MODEL_AXIS),
            "fc1_b": placements(mesh, MODEL_AXIS),
            "attn_o_w": placements(mesh, MODEL_AXIS, None),
            "fc2_w": placements(mesh, MODEL_AXIS, None),
        }

    out = {k: rep for k in params if k != "blocks"}
    out["blocks"] = [blk(bp) for bp in params["blocks"]]
    return out


def _leaf(t: torch.Tensor, like: Any) -> torch.Tensor:
    """A new leaf holding ``t`` that requires a gradient where ``like``
    did."""
    return t.detach().clone().requires_grad_(
        bool(getattr(like, "requires_grad", False)))


def shard_captioner(params: Dict, mesh, heads: int) -> Dict:
    """This rank's slices of ``params`` under ``captioner_shardings``:
    per block, the attention (qkv_w/qkv_b by whole heads of q, k and v,
    ``parallel/tensor_parallel.py``; attn_o_w's rows) when the model axis
    divides ``heads``, the MLP (fc1's columns, fc2's rows) when it
    divides the hidden width; other leaves, and int8 (``Q8``) leaves, are
    shared.  A new tree; the slices are new leaves."""
    group = axis_group(mesh, MODEL_AXIS)
    if group is None:
        return params

    def blk(bp):
        out = dict(bp)
        if is_q8(bp["qkv_w"]) or is_q8(bp["fc1_w"]):
            return out
        with torch.no_grad():
            if tp.divides(heads, group):
                out["qkv_w"] = tp.split_cols(bp["qkv_w"], group, 3)
                out["qkv_b"] = tp.split_cols(bp["qkv_b"], group, 3)
                out["attn_o_w"] = tp.split_rows(bp["attn_o_w"], group)
            if tp.divides(_shape(bp["fc1_w"])[1], group):
                out["fc1_w"] = tp.split_cols(bp["fc1_w"], group)
                out["fc1_b"] = tp.split_cols(bp["fc1_b"], group)
                out["fc2_w"] = tp.split_rows(bp["fc2_w"], group)
        return {k: _leaf(v, bp[k]) if v is not bp[k] else v
                for k, v in out.items()}

    return {**params, "blocks": [blk(bp) for bp in params["blocks"]]}


def gather_captioner(params: Dict, mesh) -> Dict:
    """The whole tree from every rank's ``shard_captioner`` slices (every
    rank of the model axis gets it; detached)."""
    group = axis_group(mesh, MODEL_AXIS)
    if group is None:
        return params

    def blk(bp):
        out = dict(bp)
        d = _shape(bp["attn_o_w"])[1]
        if _shape(bp["qkv_w"])[1] < 3 * d:
            out["qkv_w"] = tp.gather_cols(bp["qkv_w"], group, 3)
            out["qkv_b"] = tp.gather_cols(bp["qkv_b"], group, 3)
            out["attn_o_w"] = tp.gather_rows(bp["attn_o_w"], group)
        if _shape(bp["fc1_w"])[1] < 4 * d:
            out["fc1_w"] = tp.gather_cols(bp["fc1_w"], group)
            out["fc1_b"] = tp.gather_cols(bp["fc1_b"], group)
            out["fc2_w"] = tp.gather_rows(bp["fc2_w"], group)
        return out

    return {**params, "blocks": [blk(bp) for bp in params["blocks"]]}


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over ``mask`` of the next-token cross entropy: logits
    [B, T, vocab] float32, targets [B, T] integers, mask [B, T] bool.
    ``F.cross_entropy`` in float32 is the port of
    ``optax.softmax_cross_entropy_with_integer_labels``; the sum is divided
    by ``max(mask.sum(), 1)``, as the JAX losses do.  With a process
    ``group`` (the batch's rows split over it) the count is the group's
    all-reduced one: the result is this rank's share of the global mean,
    and the shares sum to it."""
    ce = F.cross_entropy(logits.float().flatten(0, 1),
                         targets.flatten().long(), reduction="none")
    m = mask.flatten().float()
    count = comm.all_reduce(m.sum(), group)
    return (ce * m).sum() / torch.clamp(count, min=1.0)


def caption_loss(tower: VisionTower, cap_params: Dict,
                 cap_cfg: CaptionerConfig, images: torch.Tensor,
                 tokens: torch.Tensor, group=None) -> torch.Tensor:
    """Masked next-byte cross entropy of captions given frames: the
    tower's embedding of ``images`` [B, S, S, 3] fills every vision slot,
    ``tokens`` [B, L] are right-padded with PAD_ID; ``group`` as for
    ``masked_cross_entropy``."""
    emb = tower(images)
    vis = emb[:, None, :].expand(-1, cap_cfg.num_vision_tokens, -1)
    logits = forward(cap_params, cap_cfg, vis, tokens[:, :-1].long())
    targets = tokens[:, 1:]
    return masked_cross_entropy(logits, targets, targets != PAD_ID, group)


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
        with profiling.span("optim.update") as sp:
            sp.set("leaves", len(self.leaves))
            for p in self.leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if self.max_norm is not None:
                with profiling.span("optim.clip"):
                    clip_by_global_norm([p.grad for p in self.leaves],
                                        self.max_norm)
            with profiling.span("optim.adamw"):
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


@dataclasses.dataclass
class TrainState:
    device: torch.device
    vit: VisionTower
    vit_cfg: ViTConfig
    cap_cfg: CaptionerConfig
    params: Dict
    opt: AdamW
    mesh: Any = None

    @classmethod
    def create(cls, vit_cfg: ViTConfig, cap_cfg: CaptionerConfig,
               device: Any = None, learning_rate: float = 1e-4,
               weight_decay: float = 0.01, seed: int = 0,
               mesh: Any = None) -> "TrainState":
        """The JAX package's seed weights for both models, each drawn from
        ``seed`` (``init_vision_tower(vit_cfg, seed)`` and
        ``init_params(cap_cfg, seed)``) on ``device`` (default:
        ``core.platform.device()``), and a fresh optimiser; over ``mesh``
        (a (data, model) ``DeviceMesh``) each rank keeps its slices.
        ``params`` is ``{"vit": {<parameter name>: parameter}, "cap":
        <captioner tree>}`` over the live parameters; ``checkpoint_tree``
        gives the tree ``TPUVLMClient`` loads."""
        if device is None:
            from ..core.platform import device as default_device

            device = default_device()
        device = torch.device(device)
        tower = init_vision_tower(vit_cfg, seed, device=device).train()
        cap = init_params(cap_cfg, seed, device=device, requires_grad=True)
        return cls.from_models(tower, cap, vit_cfg, cap_cfg, learning_rate,
                               weight_decay, mesh=mesh)

    @classmethod
    def from_models(cls, tower: VisionTower, cap_params: Dict,
                    vit_cfg: ViTConfig, cap_cfg: CaptionerConfig,
                    learning_rate: float = 1e-4,
                    weight_decay: float = 0.01,
                    mesh: Any = None) -> "TrainState":
        """A state over an existing tower and captioner tree (float32
        leaves on one device), which it trains in place; over ``mesh``
        the tower and the tree are first cut to this rank's slices."""
        if mesh is not None:
            shard_tower(tower, mesh)
            cap_params = shard_captioner(cap_params, mesh, cap_cfg.heads)
        trainable(cap_params)
        vit_tree = {name: p for name, p in tower.named_parameters()}
        for p in vit_tree.values():
            p.requires_grad_(True)
        params = {"vit": vit_tree, "cap": cap_params}
        opt = AdamW(params, learning_rate, weight_decay)
        device = cap_params["tok_emb"].device
        return cls(device=device, vit=tower, vit_cfg=vit_cfg,
                   cap_cfg=cap_cfg, params=params, opt=opt, mesh=mesh)

    def checkpoint_tree(self) -> Dict[str, Any]:
        """``{"vit": <Flax tree>, "cap": <captioner tree>}`` for
        ``checkpoint.save_params``: the tree ``TPUVLMClient`` loads (over
        a mesh, the whole tree, gathered on every rank)."""
        if self.mesh is None:
            return {"vit": param_tree(self.vit), "cap": self.params["cap"]}
        return {"vit": gather_tower_tree(self.vit, self.mesh),
                "cap": gather_captioner(self.params["cap"], self.mesh)}

    def shard_batch(self, images: np.ndarray, tokens: np.ndarray,
                    sequence_parallel: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Place a numpy batch on the device: images float32
        [B, S, S, 3], tokens int32 [B, L].  Over a mesh, this rank's
        rows (B divided over "data"); with ``sequence_parallel`` also its
        columns of the tokens (L divided over "model"), which ``loss``
        and ``step`` all-gather before the forward, where XLA gathers
        inside the attention; the loss is the same."""
        images = np.asarray(images, np.float32)
        tokens = np.asarray(tokens, np.int32)
        if self.mesh is not None:
            rows = images.shape[0] // axis_size(self.mesh, DATA_AXIS)
            lo = axis_rank(self.mesh, DATA_AXIS) * rows
            images, tokens = images[lo:lo + rows], tokens[lo:lo + rows]
            if sequence_parallel:
                cols = tokens.shape[1] // axis_size(self.mesh, MODEL_AXIS)
                c0 = axis_rank(self.mesh, MODEL_AXIS) * cols
                tokens = tokens[:, c0:c0 + cols]
        return (torch.as_tensor(np.ascontiguousarray(images),
                                device=self.device),
                torch.as_tensor(np.ascontiguousarray(tokens),
                                device=self.device))

    def loss(self, images: torch.Tensor, tokens: torch.Tensor,
             sequence_parallel: bool = False) -> torch.Tensor:
        """This rank's share of the global masked mean (its masked sum
        over every rank's mask count; the shares sum to the loss over
        "data").  Without a mesh, the loss itself."""
        if self.mesh is None:
            return caption_loss(self.vit, self.params["cap"], self.cap_cfg,
                                images, tokens)
        if sequence_parallel:
            tokens = torch.cat(comm.all_gather(
                tokens, axis_group(self.mesh, MODEL_AXIS)), dim=1)
        with use_mesh(self.mesh):
            return caption_loss(self.vit, self.params["cap"], self.cap_cfg,
                                images, tokens,
                                axis_group(self.mesh, DATA_AXIS))

    def step(self, images: torch.Tensor, tokens: torch.Tensor,
             sequence_parallel: bool = False) -> Tuple["TrainState", float]:
        self.opt.zero_grad()
        loss = self.loss(images, tokens, sequence_parallel)
        loss.backward()
        loss = loss.detach()
        if self.mesh is not None:
            group = axis_group(self.mesh, DATA_AXIS)
            self._reduce_grads(group)
            loss = comm.all_reduce(loss.clone(), group)
        self.opt.update()
        return self, loss.item()

    def _reduce_grads(self, group) -> None:
        """Sum every leaf's gradient over "data", in one flat buffer."""
        if group is None:
            return
        leaves = self.opt.leaves
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = comm.all_reduce(torch.cat([p.grad.reshape(-1)
                                          for p in leaves]), group)
        for p, g in zip(leaves, flat.split([p.numel() for p in leaves])):
            p.grad.copy_(g.view_as(p.grad))
