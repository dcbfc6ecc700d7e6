#!/usr/bin/env python3
"""Instruction-tune the byte-level chat LM for ``backend.llm: tpu`` with
the PyTorch port, on a CUDA card.

Counterpart of ``scripts/train_instruct_lm.py``: the LM learns the
pipeline's five prompt contracts by distilling the deterministic
``LocalChatClient`` teacher over a caption corpus
(``models/instruct_data.py``), benchmark-answer prompts over real
hybrid-retrieval contexts included.  Same flags, data pipeline, loss mask
(the response span only), bucket sampling, held-out loss with best pick,
resumable train state and teacher-match eval; ``--flash`` trains through
the hand-written CUDA FlashAttention kernels (forward and backward) with
remat off, otherwise through the masked einsum with remat on.  The
checkpoint is the JAX package's npz format, so either package serves it.

  python3 scripts/train_torch_instruct_lm.py \\
      --corpus vlm_output.json --steps 6000 --flash \\
      --out checkpoints/instruct_lm.npz

``--device`` defaults to ``cuda`` and raises where there is no card;
``--device cpu`` runs on the host (``--smoke`` shrinks the model and the
dataset and does not choose the device).  ``{out}.train_state.npz`` holds
the parameters, AdamW's ``exp_avg`` and ``exp_avg_sq`` and the step; it
round-trips within the port (the JAX trainer's optax state tree is not
read).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import random
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vidgraph_tpu_torch.core.platform import use_device  # noqa: E402
from vidgraph_tpu_torch.models import instruct_data, tokenizer  # noqa: E402
from vidgraph_tpu_torch.models.captioner import (  # noqa: E402
    CaptionerConfig, flash_engaged, forward,
    generate_from_tokens, init_params)
from vidgraph_tpu_torch.models.checkpoint import (  # noqa: E402
    load_params, save_params, tree_leaves)
from vidgraph_tpu_torch.models.train import (  # noqa: E402
    AdamW, masked_cross_entropy, warmup_cosine_decay_schedule)
from vidgraph_tpu_torch.services.llm_client import (  # noqa: E402
    fit_prompt_bytes)


def load_captions(path: str) -> list:
    data = json.loads(Path(path).read_text())
    if isinstance(data, dict) and "results" in data:
        return [r.get("content", "") for r in data["results"]
                if r.get("content")]
    raise ValueError("corpus must be a vlm_output.json")


def tokenize_examples(data, seq_len: int, max_new: int = 768):
    """-> list of (tokens [N, L+1], prompt_lens [N]) buckets.  Short
    examples train at half sequence length, roughly halving the average
    step cost; loss is masked to the response span downstream."""
    short_len = seq_len // 2
    buckets = {short_len: ([], []), seq_len: ([], [])}
    for task, prompt, resp in data:
        rids = tokenizer.encode(resp, add_bos=False, add_eos=True)
        if len(rids) > max_new - 8:  # over the serve decode budget: DROP,
            continue                 # never truncate (a truncated target
                                     # teaches broken JSON + EOS)
        budget = seq_len + 1 - len(rids)
        pids = tokenizer.encode(fit_prompt_bytes(prompt, budget - 8),
                                add_bos=True, add_eos=False)
        if len(pids) + len(rids) > seq_len + 1 or len(pids) < 4:
            continue
        seq = pids + rids
        length = short_len if len(seq) <= short_len + 1 else seq_len
        arr = np.full((length + 1,), tokenizer.PAD_ID, np.int32)
        arr[:len(seq)] = seq
        buckets[length][0].append(arr)
        buckets[length][1].append(len(pids))
    return [(np.stack(t), np.asarray(p, np.int32))
            for t, p in buckets.values() if t]


def instruct_loss(params: Dict, cfg: CaptionerConfig,
                  batch_toks: torch.Tensor, batch_plens: torch.Tensor,
                  remat: bool, flash: bool) -> torch.Tensor:
    """Next-byte cross entropy over the response span: ``batch_toks``
    [B, L+1] right-padded, ``batch_plens`` [B] the prompts' lengths; the
    positions from the last prompt token on that are not padding count."""
    inputs = batch_toks[:, :-1].long()
    targets = batch_toks[:, 1:]
    vis = torch.zeros((inputs.shape[0], cfg.num_vision_tokens,
                       cfg.vision_dim), dtype=torch.float32,
                      device=inputs.device)
    logits = forward(params, cfg, vis, inputs, remat=remat, flash=flash)
    pos = torch.arange(targets.shape[1], device=targets.device)[None]
    mask = (pos >= (batch_plens[:, None] - 1)) & (targets
                                                  != tokenizer.PAD_ID)
    return masked_cross_entropy(logits, targets, mask)


def token_f1(out: str, target: str) -> float:
    ta, tb = out.split(), target.split()
    common = sum((collections.Counter(ta)
                  & collections.Counter(tb)).values())
    return 2 * common / (len(ta) + len(tb)) if ta and tb and common else 0.0


def main(argv: Optional[List[str]] = None) -> Dict:
    """Train, save and evaluate; returns the run's record (the sidecar's
    fields, every step's loss and batch shape, the first batch, the
    held-out losses with the count of their evaluations, and the eval
    table)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=3072)
    ap.add_argument("--max-new", type=int, default=1024,
                    help="serve decode budget; trained responses must fit")
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-questions", type=int, default=1500)
    ap.add_argument("--n-pre", type=int, default=10000)
    ap.add_argument("--n-synth-answers", type=int, default=8000)
    ap.add_argument("--n-instr", type=int, default=2500)
    ap.add_argument("--n-consol", type=int, default=1500)
    ap.add_argument("--n-copy", type=int, default=3000)
    ap.add_argument("--out", default="checkpoints/instruct_lm.npz")
    ap.add_argument("--eval-count", type=int, default=48,
                    help="held-out examples for the teacher-match eval")
    ap.add_argument("--flash", action="store_true",
                    help="FlashAttention (CUDA kernels, forward and "
                         "backward) with remat off: one float32 per row "
                         "kept for the backward instead of the [B,h,T,T] "
                         "probabilities")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model + tiny dataset (wiring check)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from {out}.train_state.npz if present "
                         "(params + optimiser state + step; the data "
                         "pipeline is seed-deterministic, so the dataset "
                         "rebuilds identically)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = use_device(args.device)
    rng = random.Random(args.seed)

    captions = load_captions(args.corpus)
    print(f"corpus: {len(captions)} captions")
    if args.smoke:
        captions = captions[:12]
        args.n_questions = min(args.n_questions, 4)
        args.n_pre = min(args.n_pre, 12)
        args.n_synth_answers = min(args.n_synth_answers, 6)
        args.n_instr, args.n_consol, args.n_copy = 4, 4, 4
        args.eval_count = 4
    t0 = time.time()
    qc = instruct_data.real_retrieval_pairs(captions, rng, args.n_questions)
    print(f"retrieval pairs: {len(qc)} in {time.time() - t0:.1f}s")
    data = instruct_data.build_dataset(
        captions, rng, n_pre=args.n_pre, n_instr=args.n_instr,
        n_consol=args.n_consol, n_copy=args.n_copy,
        n_synth_answers=args.n_synth_answers, qc_pairs=qc)
    held = data[:args.eval_count]
    data = data[args.eval_count:]
    print(f"dataset: {len(data)} train / {len(held)} held-out "
          f"{dict(collections.Counter(t for t, _, _ in data))}")

    buckets = tokenize_examples(data, args.seq_len, args.max_new)
    print("tokenized buckets:", [b[0].shape for b in buckets])

    cfg = (CaptionerConfig(width=64, layers=2, heads=2, vision_dim=64,
                           num_vision_tokens=2, max_len=args.seq_len + 512)
           if args.smoke else CaptionerConfig.chat())
    params = init_params(cfg, args.seed,
                         device=device, requires_grad=True)
    nv = cfg.num_vision_tokens

    warmup = min(200, max(1, args.steps // 10))
    sched = warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=warmup,
        decay_steps=max(args.steps, warmup + 1),
        end_value=args.lr * 0.05)
    opt = AdamW(params, sched, weight_decay=0.01, max_norm=1.0)

    # the remat decision comes from whether flash ENGAGES on this device
    flash = flash_engaged(args.flash, device)
    print(f"device {device}; attention: {'flash' if flash else 'einsum'}, "
          f"remat={not flash}")

    def on_device(arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=device)

    # held-out LOSS batches (generalisation signal + early-stop pick)
    held_buckets = tokenize_examples(held, args.seq_len, args.max_new)

    held_evals = 0

    @torch.no_grad()
    def held_loss() -> float:
        nonlocal held_evals
        held_evals += 1
        tot = n = 0.0
        for toks_h, plens_h in held_buckets:
            m = min(16, toks_h.shape[0])
            tot += float(instruct_loss(params, cfg, on_device(toks_h[:m]),
                                       on_device(plens_h[:m]), False,
                                       flash)) * m
            n += m
        return tot / max(n, 1.0)

    def snapshot() -> Dict:
        return {k: ([{kk: vv.detach().cpu().clone()
                      for kk, vv in bp.items()} for bp in v]
                    if k == "blocks" else v.detach().cpu().clone())
                for k, v in params.items()}

    # sample buckets proportional to their example counts; short-bucket
    # batches are larger so tokens/step stays roughly constant
    weights = np.asarray([b[0].shape[0] for b in buckets], np.float64)
    weights /= weights.sum()
    best = {"loss": float("inf"), "step": -1, "params": None}

    state_path = args.out + ".train_state.npz"
    start_step = 0
    if args.resume and os.path.exists(state_path):
        template = {"params": params, "opt": opt.state_tree(),
                    "step": torch.zeros((), dtype=torch.int64)}
        state = load_params(template, state_path)
        with torch.no_grad():
            for (_, dst), (_, src) in zip(tree_leaves(params),
                                          tree_leaves(state["params"])):
                dst.copy_(src)
        opt.load_state_tree(state["opt"])
        start_step = int(state["step"]) + 1
        best["loss"] = held_loss()
        best["step"] = start_step - 1
        print(f"resumed from {state_path} at step {start_step} "
              f"(held {best['loss']:.4f})")
    held_first = best["loss"] if start_step else held_loss()
    print(f"step {start_step:5d}  HELD loss {held_first:.4f} (before)")

    def save_train_state(step: int) -> None:
        save_params({"params": params, "opt": opt.state_tree(),
                     "step": torch.tensor(step, dtype=torch.int64)},
                    state_path)

    # a fresh stream seeded by (seed, start_step) keeps resumed batch
    # order independent of how many restarts happened
    nrng = np.random.default_rng(args.seed + start_step)
    losses: List[float] = []
    shapes: List[List[int]] = []
    first_batch = None
    loss = float("nan")
    t0 = time.time()
    for step in range(start_step, args.steps):
        bi = int(nrng.choice(len(buckets), p=weights))
        toks, plens = buckets[bi]
        bsz = args.batch * (args.seq_len + 1) // toks.shape[1]
        idx = nrng.integers(0, toks.shape[0], size=max(1, bsz))
        if first_batch is None:
            first_batch = (toks[idx], plens[idx])
        opt.zero_grad()
        loss_t = instruct_loss(params, cfg, on_device(toks[idx]),
                               on_device(plens[idx]), not flash, flash)
        loss_t.backward()
        opt.update()
        loss = loss_t.item()
        losses.append(loss)
        shapes.append([len(idx), toks.shape[1] - 1])
        if step % 200 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            rate = (f"  ({(step - start_step) / dt:.1f} it/s)"
                    if step > start_step else "")
            print(f"step {step:5d}  loss {loss:.4f}{rate}")
        if (step % 1000 == 0 and step) or step == args.steps - 1:
            save_train_state(step)
            hl = held_loss()
            print(f"step {step:5d}  HELD loss {hl:.4f}")
            if hl < best["loss"]:
                best = {"loss": hl, "step": step, "params": snapshot()}
                # persist the running best so an interrupted run leaves a
                # servable checkpoint behind
                save_params(best["params"], args.out)
                Path(args.out).with_suffix(".json").write_text(json.dumps(
                    {"config": "chat", "steps": args.steps,
                     "seq_len": args.seq_len, "max_new": args.max_new,
                     "held_loss": hl, "held_best_step": step,
                     "partial": True}))

    record = {"losses": losses, "batch_shapes": shapes,
              "first_batch": first_batch,
              "held_first": held_first, "held_last": best["loss"],
              "held_evals": held_evals, "held_buckets": len(held_buckets),
              "held_examples": len(held), "layers": cfg.layers,
              "start_step": start_step, "attention":
              "flash" if flash else "einsum", "remat": not flash,
              "device": str(device), "eval": {}}
    picked = params
    if best["params"] is not None and best["step"] < args.steps - 1:
        print(f"early-stop pick: step {best['step']} "
              f"(held {best['loss']:.4f})")
        picked = best["params"]
    if best["params"] is None and start_step > 0:
        # resumed run that never improved on the pre-restart best: the
        # checkpoint on disk is already the better pick — keep it
        print(f"keeping pre-restart best (held {best['loss']:.4f})")
        return record
    save_params(picked, args.out)
    meta = {"config": "chat", "steps": args.steps, "seq_len": args.seq_len,
            "max_new": args.max_new,   # serve client pins MAX_NEW to this
            "train_examples": int(sum(b[0].shape[0] for b in buckets)),
            "final_loss": float(loss), "held_loss": best["loss"],
            "held_best_step": best["step"]}
    Path(args.out).with_suffix(".json").write_text(json.dumps(meta))
    print(f"saved {args.out}")
    record.update(meta)

    # ---- teacher-match eval on held-out prompts --------------------------
    # stay inside the trained position range (the serve client does too)
    serve = load_params(params, args.out, device=device)
    budget = min(cfg.max_len, args.seq_len) - nv - args.max_new - 2
    results = record["eval"]
    for task, prompt, target in held:
        ids = tokenizer.encode(fit_prompt_bytes(prompt, budget),
                               add_bos=True, add_eos=False)
        t_pad = 64
        while t_pad < len(ids):
            t_pad *= 2
        t_pad = min(t_pad, cfg.max_len - nv - args.max_new)
        arr = np.full((1, t_pad), tokenizer.PAD_ID, np.int32)
        arr[0, :len(ids)] = ids
        out = tokenizer.decode(generate_from_tokens(
            serve, cfg, on_device(arr), len(ids), max_new=args.max_new,
            flash=flash)[0].cpu().numpy())
        a, b = out.strip(), target.strip()
        r = results.setdefault(task, {"n": 0, "em": 0, "f1": 0.0})
        r["n"] += 1
        r["em"] += int(a == b)
        r["f1"] += token_f1(a, b)
    for task, r in sorted(results.items()):
        print(f"eval[{task}]: n={r['n']} exact={r['em']}/{r['n']} "
              f"token-f1={r['f1'] / r['n']:.3f}")
    return record


if __name__ == "__main__":
    main()
