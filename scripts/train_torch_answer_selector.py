#!/usr/bin/env python3
"""Train the answer-selection cross-encoder with the PyTorch port on one
CUDA card.

Counterpart of ``scripts/train_answer_selector.py``, with its data, loss,
flags, defaults and outputs.  Answering as selection: a byte-level
cross-encoder (the reranker trunk, ``models/reranker.py``) learns to score
the candidate sentences of a retrieved context given the question,
distilling the IDF + MMR teacher's per-sentence score distribution
(``services/llm_client.py::teacher_answer_scores``) listwise over
synthetic and real hybrid-retrieval contexts: KL to the softmax of the
teacher's scores standardised per list at ``--temp``, invalid candidates
at -1e30.  Serving assembles answers extractively from the model's scores
(``models/answer_selector.py``).

  python3 scripts/train_torch_answer_selector.py --corpus vlm_output.json \\
      --out checkpoints/answer_selector.npz

The held-out loss is read every 1000 steps and at the end; the running
best is saved as it goes (sidecar ``"partial": true``) and is the final
pick when it beats the last step.  The final sidecar records
``selector_cfg``, which ``AnswerSelector`` of either package reads.
``--data-cache``/``--build-only`` build the examples once (host work) and
train from the cache; the cache is the JAX script's format.  ``--device``
defaults to ``cuda`` and raises where there is no card; ``--smoke`` is a
tiny config and does not choose the device.  Prints one JSON line (first
and last loss, held-out losses, ms a step, peak device memory, the eval).

The dataset lives on the device (tokens as int16: torch's uint16 has
little arithmetic); a step indexes it there and keeps the columns up to
its longest pair, exact under the padding mask.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vidgraph_tpu_torch.core.platform import use_device  # noqa: E402
from vidgraph_tpu_torch.models import instruct_data, tokenizer  # noqa: E402
from vidgraph_tpu_torch.models.answer_selector import \
    AnswerSelector  # noqa: E402
from vidgraph_tpu_torch.models.captioner import trainable  # noqa: E402
from vidgraph_tpu_torch.models.checkpoint import (  # noqa: E402
    save_params, tree_leaves)
from vidgraph_tpu_torch.models.reranker import (  # noqa: E402
    RerankerConfig, batch_encode_pairs, init_reranker_params,
    reranker_scores)
from vidgraph_tpu_torch.models.text_embedder import (  # noqa: E402
    needed_columns)
from vidgraph_tpu_torch.models.train import (  # noqa: E402
    AdamW, StepClock, warmup_cosine_decay_schedule)
from vidgraph_tpu_torch.services.llm_client import (  # noqa: E402
    extractive_answer, teacher_answer_scores)


def load_captions(path: str) -> list:
    data = json.loads(Path(path).read_text())
    if isinstance(data, dict) and "results" in data:
        return [r.get("content", "") for r in data["results"]
                if r.get("content")]
    raise ValueError("corpus must be a vlm_output.json")


def truncated_candidates(q: str, ctx: str, k_cand: int,
                         rng: random.Random = None):
    """Teacher-scored candidates -> (cand, scores) or None.  Contexts
    over ``k_cand`` keep the top-(k/2) teacher-scored PLUS a random
    sample of the rest (original order).  Keeping only the top-k (round-4
    first attempt) biased training toward already-plausible sentences —
    the served model then scored never-seen junk sentences at random and
    e2e accuracy collapsed to 1/30.  The model must see the junk it is
    expected to suppress."""
    scored = teacher_answer_scores(q, ctx)
    if scored is None:
        return None
    cand, _toks, _idf, scores = scored
    if len(cand) > k_cand:
        order = sorted(range(len(cand)), key=lambda i: -scores[i])
        top = order[:k_cand // 2]
        rest = order[k_cand // 2:]
        r = rng or random
        keep = sorted(top + r.sample(rest, k_cand - len(top)))
        cand = [cand[i] for i in keep]
        scores = [scores[i] for i in keep]
    return (cand, scores) if cand else None


def build_examples(pairs, cfg: RerankerConfig, k_cand: int,
                   rng: random.Random = None):
    """(q, ctx) -> (toks [K,T] uint16, target [K] f32, valid [K] bool,
    q, ctx, teacher_answer)."""
    examples = []
    for q, ctx in pairs:
        t = truncated_candidates(q, ctx, k_cand, rng)
        if t is None:
            continue
        cand, scores = t
        toks = batch_encode_pairs(q, cand, cfg).astype(np.uint16)
        pad = np.full((k_cand - toks.shape[0], cfg.max_len),
                      tokenizer.PAD_ID, np.uint16)
        toks = np.concatenate([toks, pad]) if pad.shape[0] else toks
        target = np.full((k_cand,), -1e30, np.float32)
        target[:len(scores)] = np.asarray(scores, np.float32)
        valid = np.zeros((k_cand,), bool)
        valid[:len(scores)] = True
        examples.append((toks, target, valid, q, ctx,
                         extractive_answer(q, ctx)))
    return examples


def token_f1(a: str, b: str) -> float:
    import collections

    ta, tb = a.split(), b.split()
    common = sum((collections.Counter(ta) & collections.Counter(tb)).values())
    return 2 * common / (len(ta) + len(tb)) if ta and tb and common else 0.0


def selector_loss(params, cfg: RerankerConfig, toks: torch.Tensor,
                  tgt: torch.Tensor, valid: torch.Tensor,
                  temp: float) -> torch.Tensor:
    """The JAX script's ``loss_fn``: toks [B, K, T], teacher scores tgt
    [B, K] (-1e30 where not ``valid``) -> the mean over lists of the
    cross entropy between the softmax of the teacher's per-list
    standardised scores at ``temp`` and the model's log-softmax, both
    over the valid candidates."""
    b, k, t = toks.shape
    logits = reranker_scores(params, cfg,
                             toks.reshape(b * k, t).long()).reshape(b, k)
    logits = torch.where(valid, logits, -1e30)
    # standardize the teacher scores per list: raw IDF-overlap scores
    # have list-dependent scale, so a fixed temperature would make
    # some targets near-one-hot and others near-uniform
    nv = torch.clamp(valid.sum(-1, keepdim=True), min=1)
    vt = torch.where(valid, tgt, 0.0)
    mean = vt.sum(-1, keepdim=True) / nv
    var = (torch.where(valid, (vt - mean) ** 2, 0.0).sum(-1, keepdim=True)
           / nv)
    z = (tgt - mean) * torch.rsqrt(var + 1e-6)
    target = torch.softmax(torch.where(valid, z / temp, -1e30), dim=-1)
    logp = F.log_softmax(logits, dim=-1)
    return -(target * torch.where(valid, logp, 0.0)).sum(-1).mean()


def snapshot(params):
    """A detached copy of a parameter tree."""
    if isinstance(params, dict):
        return {k: snapshot(v) for k, v in params.items()}
    if isinstance(params, list):
        return [snapshot(v) for v in params]
    return params.detach().clone()


def selector_meta(cfg: RerankerConfig) -> Dict:
    return {"width": cfg.width, "layers": cfg.layers, "heads": cfg.heads,
            "max_len": cfg.max_len, "query_budget": cfg.query_budget}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--k-cand", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--temp", type=float, default=1.0,
                    help="softmax temperature on the teacher scores")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-synth", type=int, default=6000)
    ap.add_argument("--n-questions", type=int, default=1200)
    ap.add_argument("--eval-count", type=int, default=150)
    ap.add_argument("--out", default="checkpoints/answer_selector.npz")
    ap.add_argument("--data-cache", default="",
                    help="npz path: build examples once (CPU-friendly) "
                         "and train from the cache (chip-friendly) — "
                         "pass the same path to both invocations")
    ap.add_argument("--build-only", action="store_true",
                    help="with --data-cache: build + save, skip training")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = use_device(args.device)
    rng = random.Random(args.seed)

    captions = load_captions(args.corpus)
    cfg = (RerankerConfig.tiny() if args.smoke
           else RerankerConfig(max_len=args.max_len))
    if args.smoke:
        captions = captions[:10]
        args.n_synth, args.n_questions = 12, 4
        args.steps, args.eval_count, args.k_cand = 8, 4, 8

    if args.data_cache and os.path.exists(args.data_cache):
        z = np.load(args.data_cache, allow_pickle=True)
        examples = [tuple(e) for e in z["examples"]]
        print(f"loaded {len(examples)} examples from {args.data_cache}")
    else:
        t0 = time.time()
        sents = instruct_data.sentences_of(captions) + [
            instruct_data.synth_sentence(rng) for _ in range(1500)]
        pairs = instruct_data.synthetic_answer_pairs(sents, rng,
                                                     args.n_synth)
        pairs += instruct_data.real_retrieval_pairs(captions, rng,
                                                    args.n_questions)
        rng.shuffle(pairs)
        print(f"pairs: {len(pairs)} in {time.time() - t0:.1f}s")
        examples = build_examples(pairs, cfg, args.k_cand, rng)
        if args.data_cache:
            np.savez_compressed(
                args.data_cache,
                examples=np.asarray(examples, dtype=object))
            print(f"cached {len(examples)} examples -> {args.data_cache}")
            if args.build_only:
                return {"examples": len(examples)}
    held = examples[:args.eval_count]
    train = examples[args.eval_count:]
    print(f"examples: {len(train)} train / {len(held)} held "
          f"(K={args.k_cand}, T={cfg.max_len})")

    def on_device(rows):
        toks = np.stack([e[0] for e in rows])                  # [N,K,T]
        return (torch.as_tensor(toks.astype(np.int16), device=device),
                torch.as_tensor(np.stack([e[1] for e in rows]),
                                device=device),                # [N,K] f32
                torch.as_tensor(np.stack([e[2] for e in rows]),
                                device=device),                # [N,K] bool
                needed_columns(toks))

    # device-resident dataset: no upload a step
    toks_all, tgt_all, val_all, lens_all = on_device(train)
    htoks, htgt, hval, hlens = on_device(held)

    params = trainable(init_reranker_params(cfg, args.seed, device))
    warmup = min(200, max(1, args.steps // 10))
    sched = warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=warmup,
        decay_steps=max(args.steps, warmup + 1), end_value=args.lr * 0.05)
    opt = AdamW(params, sched, weight_decay=0.01, max_norm=1.0)
    temp = args.temp

    @torch.no_grad()
    def held_loss() -> float:
        tot = 0.0
        m = 16
        for i in range(0, htoks.shape[0], m):
            bsz = min(m, htoks.shape[0] - i)
            t = int(hlens[i:i + m].max())
            tot += selector_loss(params, cfg, htoks[i:i + m, :, :t],
                                 htgt[i:i + m], hval[i:i + m],
                                 temp).item() * bsz
        return tot / max(1, htoks.shape[0])

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    clock = StepClock(device)
    nrng = np.random.default_rng(args.seed)
    best = {"loss": float("inf"), "step": -1, "params": None}
    losses, held_losses = [], []
    t0 = time.time()
    for step in range(args.steps):
        if step == 1:
            clock.start()           # step 0 carries the warm-up
        idx = nrng.integers(0, len(train), size=args.batch)
        t = int(lens_all[idx].max())
        idx_d = torch.as_tensor(idx, device=device)
        opt.zero_grad()
        loss = selector_loss(params, cfg, toks_all[idx_d, :, :t],
                             tgt_all[idx_d], val_all[idx_d], temp)
        loss.backward()
        opt.update()
        losses.append(loss.detach())
        if step % 200 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            rate = f"  ({step / dt:.1f} it/s)" if step else ""
            print(f"step {step:5d}  loss {loss.item():.4f}{rate}")
        if (step % 1000 == 0 and step) or step == args.steps - 1:
            clock.stop()
            hl = held_loss()
            held_losses.append((step, hl))
            print(f"step {step:5d}  HELD loss {hl:.4f}")
            if hl < best["loss"]:
                best = {"loss": hl, "step": step,
                        "params": snapshot(params)}
                # persist the running best so a machine reset (or a
                # deadline-bounded run killed by PID) leaves a servable
                # checkpoint behind
                save_params(best["params"], args.out)
                Path(args.out).with_suffix(".json").write_text(json.dumps(
                    {"selector_cfg": selector_meta(cfg),
                     "steps": args.steps, "held_loss": hl,
                     "held_best_step": step, "partial": True}))
            clock.start()
    clock.stop()
    losses = torch.stack(losses).tolist()

    if best["params"] is not None and best["step"] < args.steps - 1:
        print(f"early-stop pick: step {best['step']} "
              f"(held {best['loss']:.4f})")
        params = best["params"]
    save_params(params, args.out)
    meta = {"selector_cfg": selector_meta(cfg),
            "steps": args.steps, "train_examples": len(train)}
    Path(args.out).with_suffix(".json").write_text(json.dumps(meta))
    print(f"saved {args.out}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else None

    # ---- held-out eval: does the model reproduce the teacher's answers? --
    sel = AnswerSelector(checkpoint_path=args.out)
    top1 = em = 0
    f1 = 0.0
    for _toks_e, _tgt_e, _valid_e, q, ctx, teacher_ans in held:
        t = truncated_candidates(q, ctx, args.k_cand, rng)
        if t is None:
            continue
        cand, tscores = t
        s = sel.score(q, cand)
        top1 += int(np.argmax(s) == int(np.argmax(tscores)))
        model_ans = sel.answer(q, ctx)
        em += model_ans == teacher_ans
        f1 += token_f1(model_ans, teacher_ans)
    n = max(1, len(held))
    print(f"eval: top1-agreement {top1}/{n} = {top1 / n:.3f}  "
          f"answer-exact {em}/{n} = {em / n:.3f}  "
          f"answer-F1 {f1 / n:.3f}")
    rec = {"config": selector_meta(cfg),
           "device": torch.cuda.get_device_name(device) if cuda else "cpu",
           "steps": args.steps, "batch": args.batch, "k_cand": args.k_cand,
           "train_examples": len(train), "held_examples": len(held),
           "params_m": sum(p.numel() for _, p in tree_leaves(params)) / 1e6,
           "first_loss": losses[0], "last_loss": losses[-1],
           "held_losses": held_losses, "best_step": best["step"],
           "step_ms": clock.ms_per_step(args.steps - 1),
           "peak_memory_gb": peak / 2 ** 30 if cuda else None,
           "eval": {"top1_agreement": top1 / n, "answer_exact": em / n,
                    "answer_f1": f1 / n}}
    print(json.dumps(rec))
    return {**rec, "losses": losses}


if __name__ == "__main__":
    main()
