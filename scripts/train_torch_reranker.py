#!/usr/bin/env python3
"""Train the cross-encoder reranker (``backend.reranker: trained``) with
the PyTorch port on one CUDA card.

Counterpart of ``scripts/train_reranker.py``, with its data, objective,
flags, defaults and outputs.  Self-labelled from the caption corpus: for
each chunk, template questions grounded in that chunk's content make it
the positive; hard negatives are the hashed embedder's nearest other
chunks plus random chunks, and compositional synthetic groups are mixed
in.  The objective is a residual on the embedder's cosine prior: listwise
softmax cross entropy over ``scores + lam * cosine`` of each (1 positive +
11 negatives) group, plus ``score_reg * mean(scores^2)``; the optimiser is
``clip_by_global_norm(1.0)`` then AdamW (decay 0.01) on a warmup-cosine
schedule.  Held-out evaluation reports top-1 and MRR against the cosine
baseline.

  python3 scripts/train_torch_reranker.py --corpus vlm_output.json \\
      --steps 2000 --out checkpoints/reranker.npz

Writes the npz (the JAX package's format: either package serves it) and
its ``.json`` sidecar ``{"config", "steps", "final_loss",
"cosine_lambda"}``; prints one JSON line (first and last loss, ms a step,
peak device memory, the held-out numbers).  ``--device`` defaults to
``cuda`` and raises where there is no card; ``--tiny`` is the small
config and does not choose the device.

The groups' tokens live on the device as int16; a step indexes them there
and keeps the columns up to its longest pair (the padding mask makes the
rest exact zeros), where the JAX script uploads every batch at 512 bytes.
"""
from __future__ import annotations

import argparse
import json
import random
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vidgraph_tpu_torch.core.platform import use_device  # noqa: E402
from vidgraph_tpu_torch.models.captioner import trainable  # noqa: E402
from vidgraph_tpu_torch.models.checkpoint import save_params  # noqa: E402
from vidgraph_tpu_torch.models.reranker import (  # noqa: E402
    RerankerConfig, batch_encode_pairs, init_reranker_params,
    reranker_scores, score_tokens)
from vidgraph_tpu_torch.models.text_embedder import (  # noqa: E402
    needed_columns)
from vidgraph_tpu_torch.models.train import (  # noqa: E402
    AdamW, StepClock, warmup_cosine_decay_schedule)

_COLOR = re.compile(
    r"\b(red|blue|green|yellow|white|black|gray|grey|orange|purple|brown|"
    r"transparent|silver)\s+([a-z]{3,})", re.IGNORECASE)
_VERB = re.compile(
    r"\b(?:person|scientist|researcher|hand|he|she|they)\b[^.]*?\b"
    r"(holds?|pours?|adjusts?|uses?|opens?|places?|measures?|picks?|"
    r"touches?|carries?|examines?|wears?)\b\s+(?:the|a|an)?\s*"
    r"([a-z]{3,})", re.IGNORECASE)
_NUMBER = re.compile(r"-?\d+\.\d+\s*(g|ml|kg|cm|mm|°c)?", re.IGNORECASE)


def queries_for(chunk: str, rng: random.Random) -> list:
    qs = []
    m = _COLOR.search(chunk)
    if m:
        qs.append(rng.choice([
            f"What color is the {m.group(2).lower()}?",
            f"Where is the {m.group(1).lower()} {m.group(2).lower()}?",
        ]))
    m = _VERB.search(chunk)
    if m:
        verb = m.group(1).lower().rstrip("s")
        obj = m.group(2).lower()
        qs.append(rng.choice([
            f"What does the person {verb}?",
            f"What does the person do with the {obj}?",
            f"When does the person {verb} the {obj}?",
        ]))
    if _NUMBER.search(chunk):
        qs.append(rng.choice([
            "What is the reading on the balance?",
            "What value is displayed?",
            "What is the measurement shown?",
        ]))
    words = [w.lower() for w in re.findall(r"[A-Za-z]{5,}", chunk)]
    if words:
        w = rng.choice(words)
        qs.append(rng.choice([
            f"When does the {w} appear?",
            f"What is near the {w}?",
        ]))
    return qs


def _dropout_words(q: str, rng: random.Random, p: float = 0.15) -> str:
    words = q.split()
    if len(words) < 4:
        return q
    kept = [w for w in words if rng.random() > p]
    return " ".join(kept) if len(kept) >= 3 else q


def build_groups(chunks, rng: random.Random, n_negs: int = 11,
                 samplings_per_query: int = 2):
    """-> list of (query, docs[1+K], pos_idx) with hard+random negatives.

    Each query gets ``samplings_per_query`` independent negative draws
    (the fixed-group memorization failure mode showed up as held-out
    top-1 BELOW the cosine baseline) and 15% query word-dropout."""
    from vidgraph_tpu_torch.services.embed_client import make_embed_client

    embed = make_embed_client("tpu", dim=512)
    vecs = embed.embed(list(chunks))
    sims = vecs @ vecs.T
    np.fill_diagonal(sims, -1.0)
    hard = np.argsort(-sims, axis=1)[:, :10]

    groups = []
    for i, chunk in enumerate(chunks):
        for q in queries_for(chunk, rng):
            for _ in range(samplings_per_query):
                n_hard = rng.randint(3, n_negs // 2 + 1)
                negs = list(rng.sample(list(hard[i]), n_hard))
                while len(negs) < n_negs:
                    j = rng.randrange(len(chunks))
                    if j != i and j not in negs:
                        negs.append(j)
                docs = [chunk] + [chunks[j] for j in negs]
                order = list(range(len(docs)))
                rng.shuffle(order)
                docs = [docs[k] for k in order]
                pos = order.index(0)
                groups.append((_dropout_words(q, rng), docs, pos))
    rng.shuffle(groups)
    return groups


_SYN_COLORS = ["red", "blue", "green", "yellow", "white", "black", "gray",
               "orange", "purple", "brown", "transparent", "silver"]
_SYN_OBJECTS = ["beaker", "flask", "balance", "smartphone", "glove",
                "pipette", "notebook", "monitor", "bottle", "stirrer",
                "scale", "tray", "goggles", "cylinder", "funnel", "burner",
                "thermometer", "syringe", "clamp", "rack"]
_SYN_VERBS = ["holds", "pours", "adjusts", "uses", "opens", "places",
              "measures", "picks up", "touches", "carries", "examines"]


def synthetic_groups(rng: random.Random, n_groups: int, n_negs: int = 11):
    """Compositional groups: the positive is the ONLY doc matching the
    queried (color, object) or (verb, object) combination, negatives
    reuse the same vocabulary — teaches term matching, not memory."""
    groups = []
    for _ in range(n_groups):
        color = rng.choice(_SYN_COLORS)
        obj = rng.choice(_SYN_OBJECTS)
        verb = rng.choice(_SYN_VERBS)
        pos_doc = (f"The person {verb} the {color} {obj} on the bench "
                   f"near a {rng.choice(_SYN_COLORS)} "
                   f"{rng.choice(_SYN_OBJECTS)}.")
        q = rng.choice([
            f"What color is the {obj}?",
            f"What does the person do with the {obj}?",
            f"Where is the {color} {obj}?",
            f"What does the person {verb.split()[0]}?",
        ])
        docs = [pos_doc]
        while len(docs) < 1 + n_negs:
            c2 = rng.choice(_SYN_COLORS)
            o2 = rng.choice(_SYN_OBJECTS)
            v2 = rng.choice(_SYN_VERBS)
            if o2 == obj and (c2 == color or v2 == verb):
                continue                      # would be a second positive
            docs.append(f"The person {v2} the {c2} {o2} on the bench "
                        f"near a {rng.choice(_SYN_COLORS)} "
                        f"{rng.choice(_SYN_OBJECTS)}.")
        order = list(range(len(docs)))
        rng.shuffle(order)
        docs = [docs[k] for k in order]
        groups.append((q, docs, order.index(0)))
    return groups


def cosine_prior(groups, embed) -> np.ndarray:
    """[G, n_docs] float32: each document's cosine to its group's query
    under ``embed`` (the residual objective's prior)."""
    sims = np.zeros((len(groups), len(groups[0][1])), np.float32)
    for g, (q, docs, _) in enumerate(groups):
        vecs = embed.embed([q] + list(docs))
        sims[g] = vecs[1:] @ vecs[0]
    return sims


def reranker_loss(params, cfg: RerankerConfig, toks: torch.Tensor,
                  pos: torch.Tensor, sims: torch.Tensor, lam: float,
                  score_reg: float) -> torch.Tensor:
    """The JAX script's ``loss_fn``: softmax cross entropy of ``scores +
    lam * sims`` against the positive's index, plus ``score_reg *
    mean(scores^2)``; toks [G, n_docs, T], pos [G], sims [G, n_docs]."""
    g, d, t = toks.shape
    scores = reranker_scores(params, cfg,
                             toks.reshape(g * d, t).long()).reshape(g, d)
    logits = scores + lam * sims
    ce = F.cross_entropy(logits, pos.long())
    return ce + score_reg * torch.mean(torch.square(scores))


def heldout_eval(params, cfg: RerankerConfig, held, embed, lam: float,
                 device: torch.device) -> Dict[str, float]:
    """Top-1 and MRR of the trained scores (+ the cosine prior) and of the
    cosine baseline on the held-out groups."""
    top1 = mrr = 0.0
    base_top1 = base_mrr = 0.0
    for q, docs, p_idx in held:
        vq = embed.embed([q] + list(docs))
        s = score_tokens(params, cfg, batch_encode_pairs(q, docs, cfg),
                         device)
        s = s + lam * (vq[1:] @ vq[0])
        rank = int(np.where(np.argsort(-s) == p_idx)[0][0]) + 1
        top1 += rank == 1
        mrr += 1.0 / rank
        bs = vq[1:] @ vq[0]
        brank = int(np.where(np.argsort(-bs) == p_idx)[0][0]) + 1
        base_top1 += brank == 1
        base_mrr += 1.0 / brank
    n = max(1, len(held))
    return {"top1": top1 / n, "mrr": mrr / n, "cosine_top1": base_top1 / n,
            "cosine_mrr": base_mrr / n, "n": len(held)}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--groups-per-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--heldout", type=int, default=120)
    ap.add_argument("--lam", type=float, default=8.0,
                    help="cosine-prior weight in the residual objective")
    ap.add_argument("--score-reg", type=float, default=0.02,
                    help="L2 penalty on cross-encoder scores: the residual "
                         "stays near zero unless it genuinely pays")
    ap.add_argument("--synth-groups", type=int, default=3000)
    ap.add_argument("--out", default="checkpoints/reranker.npz")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = use_device(args.device)
    rng = random.Random(args.seed)

    data = json.loads(Path(args.corpus).read_text())
    captions = [r["content"] for r in data["results"] if r.get("content")]
    # doc unit = the stored chunk contents the serve-time reranker sees
    chunks = list(dict.fromkeys(captions))
    print(f"{len(chunks)} corpus chunks")

    corpus_groups = build_groups(chunks, rng)
    rng.shuffle(corpus_groups)
    held = corpus_groups[:args.heldout]       # held-out = corpus style
    groups = (corpus_groups[args.heldout:]
              + synthetic_groups(rng, args.synth_groups))
    rng.shuffle(groups)
    print(f"{len(groups)} train groups ({args.synth_groups} synthetic) / "
          f"{len(held)} held-out")

    cfg = RerankerConfig.tiny() if args.tiny else RerankerConfig()
    params = trainable(init_reranker_params(cfg, seed=args.seed,
                                            device=device))

    # pre-tokenize all groups: [G, n_docs, T], kept on the device
    toks = np.stack([batch_encode_pairs(q, docs, cfg)
                     for q, docs, _ in groups])
    lens = needed_columns(toks)
    pos = np.array([p for _, _, p in groups], np.int32)
    # residual objective: training logits = cross + lambda * cosine prior,
    # so a zero-signal model reproduces the cosine baseline exactly
    from vidgraph_tpu_torch.services.embed_client import make_embed_client

    embed = make_embed_client("tpu", dim=512)
    sims = cosine_prior(groups, embed)
    print(f"tokenized {toks.shape} (cosine prior lambda={args.lam})")
    toks_d = torch.as_tensor(toks.astype(np.int16), device=device)
    pos_d = torch.as_tensor(pos, device=device)
    sims_d = torch.as_tensor(sims, device=device)

    warmup = min(100, max(1, args.steps // 10))
    sched = warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=warmup,
        decay_steps=max(args.steps, warmup + 1), end_value=args.lr * 0.05)
    opt = AdamW(params, sched, weight_decay=0.01, max_norm=1.0)

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    clock = StepClock(device)
    nrng = np.random.default_rng(args.seed)
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        if step == 1:
            clock.start()           # step 0 carries the warm-up
        idx = nrng.integers(0, toks.shape[0], size=args.groups_per_batch)
        t = int(lens[idx].max())
        idx_d = torch.as_tensor(idx, device=device)
        opt.zero_grad()
        loss = reranker_loss(params, cfg, toks_d[idx_d, :, :t],
                             pos_d[idx_d], sims_d[idx_d], args.lam,
                             args.score_reg)
        loss.backward()
        opt.update()
        losses.append(loss.detach())
        if step % 200 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            rate = f"  ({step / dt:.1f} it/s)" if step else ""
            print(f"step {step:5d}  loss {loss.item():.4f}{rate}")
    clock.stop()
    losses = torch.stack(losses).tolist()

    save_params(params, args.out)
    Path(args.out).with_suffix(".json").write_text(json.dumps(
        {"config": "tiny" if args.tiny else "default",
         "steps": args.steps, "final_loss": float(losses[-1]),
         "cosine_lambda": args.lam}))
    print(f"saved {args.out}")

    # ---- held-out eval vs the cosine baseline ---------------------------
    ev = heldout_eval(params, cfg, held, embed, args.lam, device)
    print(f"held-out: trained top1 {ev['top1']:.3f} mrr {ev['mrr']:.3f} | "
          f"cosine baseline top1 {ev['cosine_top1']:.3f} "
          f"mrr {ev['cosine_mrr']:.3f}")
    rec = {"config": "tiny" if args.tiny else "default",
           "device": torch.cuda.get_device_name(device) if cuda else "cpu",
           "steps": args.steps, "groups": len(groups),
           "groups_per_batch": args.groups_per_batch,
           "first_loss": losses[0], "last_loss": losses[-1],
           "step_ms": clock.ms_per_step(args.steps - 1),
           "peak_memory_gb": (torch.cuda.max_memory_allocated(device)
                              / 2 ** 30 if cuda else None),
           "heldout": ev}
    print(json.dumps(rec))
    return {**rec, "losses": losses}


if __name__ == "__main__":
    main()
