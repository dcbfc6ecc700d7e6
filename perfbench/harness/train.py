"""Traffic of kind ``train``: the chat LM's training step, closed loop, one
optimizer step after another.

The step is the instruct trainer's, composed of the port's functions:
``captioner.forward(..., flash=True)`` with the vision slots zero, the
response-span ``train.masked_cross_entropy``, ``backward``, and
``train.AdamW`` (the clip by global norm, then AdamW with the
warmup-cosine schedule).  Set-up draws the weights from the seed (the
port's ``init_params``), builds the optimizer with its count at the
configuration's ``start_count`` (past the warmup, so that every step runs
at a learning rate the window runs), and drives that one object through
the mix's first ``check_steps`` steps, on batches of distinct rows made by
the same generator as the window's; the window then continues with the
same object.

The window runs steps until ``seconds`` have passed, with at most two
steps queued on the card, and records a CUDA event at each step boundary:
``train_tokens_per_s`` is batch x seq_len of every step over the time up to
the last step's end (after a synchronise); ``train_step_p95_ms`` is the
95th percentile of the times between the events.

Correctness: the set-up's steps are followed by the float32 reference
(``reference/``) from its own draw of the seed's weights, on the same
batches.  ``loss_gap``: the largest relative gap of a step's loss;
``grad_gap``: the worst leaf's gap of the first gradient's norm as the
optimizer got it (its first moment after one step over 1 - b1);
``delta_gap``: the worst leaf's gap of the norm of the parameters' change
over the steps, leaving out leaves whose reference gradient norm is under a
thousandth of the median leaf's.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, List, Optional

import torch

from . import compare, generate
from .trace import DeviceTrace, SetupClock, Spans

_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B1 = 0.9


class Trainer:
    """The training step over the port's functions."""

    def __init__(self, config: Dict, mix: Dict, seed: int,
                 device: torch.device) -> None:
        from vidgraph_tpu_torch.models.captioner import (
            CaptionerConfig, flash_engaged, init_params)
        from vidgraph_tpu_torch.models.train import (
            AdamW, warmup_cosine_decay_schedule)

        sizes = {k: v for k, v in config["captioner"].items()
                 if k != "param_dtype"}
        self.cfg = CaptionerConfig(**dict(sizes,
                                          dtype=_TYPES[sizes["dtype"]]))
        tr = config["training"]
        self.params = init_params(self.cfg, seed, device=device,
                                  requires_grad=True)
        sched = warmup_cosine_decay_schedule(
            0.0, tr["lr_peak"], warmup_steps=tr["warmup"],
            decay_steps=tr["decay_steps"], end_value=tr["lr_end"])
        self.opt = AdamW(self.params, sched, weight_decay=tr["weight_decay"],
                         max_norm=tr["max_norm"])
        self.opt.count = tr["start_count"]
        self.flash = flash_engaged(tr["flash"], device)
        self.pad = mix["pad_id"]
        self.vis = torch.zeros((mix["batch"], self.cfg.num_vision_tokens,
                                self.cfg.vision_dim), device=device)

    def step(self, toks: torch.Tensor, plens: torch.Tensor,
             spans: Optional[Spans] = None) -> torch.Tensor:
        from vidgraph_tpu_torch.models.captioner import forward
        from vidgraph_tpu_torch.models.train import masked_cross_entropy

        timed = spans.timed if spans is not None else _untimed
        self.opt.zero_grad()
        inputs, targets = toks[:, :-1].long(), toks[:, 1:]
        with timed("train.forward"):
            logits = forward(self.params, self.cfg, self.vis, inputs,
                             remat=False, flash=self.flash)
            pos = torch.arange(targets.shape[1], device=targets.device)[None]
            mask = (pos >= plens[:, None] - 1) & (targets != self.pad)
            loss = masked_cross_entropy(logits, targets, mask)
        with timed("train.backward"):
            loss.backward()
        with timed("train.optimizer", sync_start=True):
            self.opt.update()
        return loss.detach()

    def leaves(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.opt.keys, self.opt.leaves))

    def first_moments(self) -> Dict[str, torch.Tensor]:
        state = self.opt.opt.state
        return {k: state[p]["exp_avg"] if p in state else torch.zeros_like(p)
                for k, p in self.leaves().items()}


def _untimed(name: str, sync_start: bool = False):
    return contextlib.nullcontext()


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(t.detach().float().norm()) for k, t in tree.items()}


def setup_steps(trainer: Trainer, batches, n: int) -> Dict:
    """The first ``n`` steps of ``trainer``: their batches (on the host),
    losses, the per-leaf norms of the first gradient the optimizer got and
    of the change of every leaf over the ``n`` steps."""
    start = {k: p.detach().clone() for k, p in trainer.leaves().items()}
    out: Dict = {"batches": [], "losses": []}
    for i in range(n):
        toks, plens = next(batches)
        out["batches"].append((toks.cpu(), plens.cpu()))
        out["losses"].append(float(trainer.step(toks, plens)))
        if i == 0:
            out["grad_norms"] = {k: v / (1 - B1) for k, v in
                                 _norms(trainer.first_moments()).items()}
    out["delta_norms"] = {k: float((p.detach() - start[k]).norm())
                          for k, p in trainer.leaves().items()}
    return out


def run(cell, seed: int, seconds: float, trace: bool,
        clock: SetupClock, device: torch.device, keep: bool = False) -> Dict:
    """One run of the cell; ``keep`` also returns the set-up steps'
    readings, for the control's."""
    mix = cell.traffic
    clock.mark("imports")
    trainer = Trainer(cell.config, mix, seed, device)
    clock.mark("weights")
    batches = generate.byte_batches(mix, seed, device)
    first = setup_steps(trainer, batches, mix["check_steps"])
    spans = Spans()
    dtrace = DeviceTrace() if trace else None
    # the profiler records steps [lo, hi); spans time steps [hi, end)
    lo, hi = mix["trace_skip"], mix["trace_skip"] + mix["trace_steps"]
    end = hi + mix["trace_steps"]
    cuda = device.type == "cuda"
    marks: List = []
    losses: List[torch.Tensor] = []
    setup_s = clock.stop()
    t0 = time.perf_counter()
    marks.append(_mark(cuda))
    n = 0
    while True:
        toks, plens = next(batches)
        if dtrace is not None and n == lo:
            dtrace.start()
        spans.timing = n >= hi
        labelled = dtrace is not None and lo <= n < end
        losses.append(trainer.step(toks, plens, spans if labelled else None))
        marks.append(_mark(cuda))
        n += 1
        if dtrace is not None and n == hi:
            dtrace.stop()
        if len(marks) > 3 and cuda:
            marks[-3].synchronize()
        if time.perf_counter() - t0 >= seconds and (dtrace is None
                                                    or n >= end):
            break
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])] \
        if cuda else [elapsed * 1e3 / n] * n
    finite = int(torch.isfinite(torch.stack(losses)).sum())
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    tokens = mix["batch"] * mix["seq_len"]
    del trainer, losses
    if cuda:
        torch.cuda.empty_cache()
    out = {"setup_s": setup_s, "attempted": n, "failed": n - finite,
           "end_to_end": {
               "train_tokens_per_s": tokens * n / elapsed,
               "train_step_p95_ms": statistics.quantiles(
                   step_ms, n=100, method="inclusive")[94] if n > 1
               else step_ms[0],
               "setup_s": setup_s},
           "memory_peak_bytes": peak,
           "numbers": check(cell, seed, first, device),
           "spans": dict(spans.seconds), "trace": dtrace,
           "counters": {"steps": n, "window_s": elapsed, "step_ms": step_ms,
                        "traced_steps": mix["trace_steps"] if trace else 0,
                        "tokens_per_step": tokens}}
    if keep:
        out["first"] = first
    return out


def _mark(cuda: bool):
    if not cuda:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def reference_steps(cell, seed: int, batches, device: torch.device,
                    rnd_name: str = "float32") -> Dict:
    """The reference's losses and per-leaf norms over ``batches``, from
    its own draw of the seed's weights, one row at a time (the loss is the
    mean over every row's response span, so the rows' gradients add)."""
    from torch.utils.checkpoint import checkpoint

    from ..reference import captioner as ref_cap
    from ..reference import lowp, optim

    lowp.no_tf32()
    rnd = lowp.rounding(rnd_name)
    conf, mix = cell.config, cell.traffic
    cs, tr = conf["captioner"], conf["training"]
    params = ref_cap.init_params(cs, seed, cs["param_dtype"], device,
                                 requires_grad=True)
    leaves = ref_cap.leaves(params)
    start = {k: p.detach().clone() for k, p in leaves.items()}
    opt = optim.AdamW(leaves, tr["weight_decay"])
    nv, dim = cs["num_vision_tokens"], cs["vision_dim"]
    out: Dict = {"losses": []}
    start_count = tr["start_count"]

    def block_fn(fn, x):
        return checkpoint(fn, x, use_reentrant=False)

    for i, (toks, plens) in enumerate(batches):
        toks, plens = toks.to(device), plens.to(device)
        inputs, targets = toks[:, :-1], toks[:, 1:]
        mask = optim.response_mask(targets, plens, mix["pad_id"])
        count = float(mask.sum().clamp(min=1))
        for p in leaves.values():
            p.grad = None
        total = 0.0
        for r in range(len(toks)):
            logits = ref_cap.forward(
                params, cs, torch.zeros((1, nv, dim), device=device),
                inputs[r:r + 1], rnd, block_fn=block_fn)
            loss = optim.ce_sum(logits, targets[r:r + 1],
                                mask[r:r + 1]) / count
            loss.backward()
            total += float(loss.detach())
        out["losses"].append(total)
        grads = optim.clip([leaves[k].grad for k in leaves], tr["max_norm"])
        grads = dict(zip(leaves, grads))
        if i == 0:
            out["grad_norms"] = _norms(grads)
        opt.update(grads, optim.lr_at(
            start_count + i, tr["lr_peak"], tr["warmup"], tr["decay_steps"],
            tr["lr_end"]))
    out["delta_norms"] = {k: float((p.detach() - start[k]).norm())
                          for k, p in leaves.items()}
    return out


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers of one side's steps against the reference's."""
    g = ref["grad_norms"]
    median = statistics.median(g.values())
    moved = [k for k, v in g.items() if v >= 1e-3 * median]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in
                        zip(prog["losses"], ref["losses"])),
        "grad_gap": compare.leaf_gap(prog["grad_norms"], g),
        "delta_gap": compare.leaf_gap(prog["delta_norms"],
                                      ref["delta_norms"], moved)}


def check(cell, seed: int, first: Dict, device: torch.device
          ) -> Dict[str, float]:
    ref = reference_steps(cell, seed, first["batches"], device)
    return gaps(first, ref)


def control(cell, seed: int, out: Dict, device: torch.device,
            lower: str = "fp8") -> Dict[str, float]:
    """The control's readings: the reference computed in ``lower``
    precision, in the program's place, against the float32 reference on
    the batches of ``out``, a run's output kept with ``keep``."""
    first = out["first"]
    ref = reference_steps(cell, seed, first["batches"], device)
    low = reference_steps(cell, seed, first["batches"], device, lower)
    return gaps(low, ref)
