#!/usr/bin/env python3
"""Contrastive training of the byte-level ``TransformerTextEmbedder``
with the PyTorch port on one CUDA card.

Counterpart of ``scripts/train_text_embedder.py``, with its data, loss,
flags, defaults and outputs.  Self-supervised domain adaptation on
caption text:

* a query-shaped view of each document (a few content words in document
  order) pulled to its document with symmetric InfoNCE at ``--tau``
  against in-batch negatives;
* a hash-teacher distillation term, ``--distill`` x the mean squared
  difference between the student's document cosine matrix and the
  ``HashedNGramEmbedder``'s, which anchors the lexical matching the
  retrieval stack relies on.

The encoder is ``CaptionerConfig(width, layers, heads, vision_dim=width,
num_vision_tokens=1, max_len=max_len + 1)`` computing in bfloat16 with
float32 parameters; AdamW (decay 1e-4, no clip) on a cosine decay to 0.1
x ``--lr``.  Corpus: a text file (one passage per line) or a
vlm_output.json whose captions and their sentences are the documents.

  python3 scripts/train_torch_text_embedder.py --corpus vlm_output.json \\
      --steps 600 --out checkpoints/text_embedder.npz

Writes the npz and its sidecar ``{width, layers, heads, dim, max_len,
eval_recall_at_1, hash_recall_at_1, steps, corpus}``, which
``make_embed_client("transformer"|"hybrid", checkpoint_path=...)`` of
either package reads back; prints one JSON line (losses, held-out
recall@1 against the hash teacher's, ms a step, peak device memory).
``--device`` defaults to ``cuda`` and raises where there is no card.
Each batch is tokenised on the host and sent without its trailing all-pad
columns (exact under the padding mask), where the JAX script sends
``--max-len`` / ``--query-len`` bytes.
"""
from __future__ import annotations

import argparse
import json
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
from vidgraph_tpu_torch.models import tokenizer  # noqa: E402
from vidgraph_tpu_torch.models.captioner import (  # noqa: E402
    CaptionerConfig, trainable)
from vidgraph_tpu_torch.models.checkpoint import save_params  # noqa: E402
from vidgraph_tpu_torch.models.text_embedder import (  # noqa: E402
    HashedNGramEmbedder, encoder_forward, init_encoder_params,
    trim_padding)
from vidgraph_tpu_torch.models.train import (  # noqa: E402
    AdamW, StepClock, cosine_decay_schedule)


_STOP = frozenset("""
a an the and or of to in on at is are was were be been being this that
these those with for from by as it its his her their our your we you they
he she i then than there here what which who when where why how not no
""".split())


def load_sentences(path: str, min_chars: int = 24) -> list:
    """Positive *documents*: whole captions (json) or lines (txt), plus
    their sentences — the retrieval task matches short queries against
    multi-sentence chunk documents, so both granularities train."""
    text = Path(path).read_text()
    if path.endswith(".json"):
        data = json.loads(text)
        bodies = [r.get("content", "") for r in data.get("results", [])]
    else:
        bodies = text.splitlines()
    docs, seen = [], set()
    for body in bodies:
        body = body.strip()
        if len(body) >= min_chars and body.lower()[:256] not in seen:
            seen.add(body.lower()[:256])
            docs.append(body)
        for s in re.split(r"(?<=[.!?])\s+|\n+", body):
            s = s.strip(" -*#")
            if len(s) >= min_chars and s.lower()[:256] not in seen:
                seen.add(s.lower()[:256])
                docs.append(s)
    return docs


def augment(sent: str, rng: np.random.Generator) -> str:
    """Query-shaped view: a small sample of informative (non-stopword)
    words in document order — benchmark queries mention a handful of
    content words scattered across the chunk, not a contiguous span."""
    words = sent.split()
    content_idx = [i for i, w in enumerate(words)
                   if w.lower().strip(".,!?:;()\"'") not in _STOP]
    if len(content_idx) >= 4:
        n = int(rng.integers(3, min(9, len(content_idx))))
        pick = sorted(rng.choice(len(content_idx), size=n, replace=False))
        words = [words[content_idx[i]] for i in pick]
    elif len(words) > 4:
        keep = rng.random(len(words)) > 0.1
        keep[0] = True
        words = [w for w, k in zip(words, keep) if k]
    return " ".join(words)


def encoder_config(width: int, layers: int, heads: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> CaptionerConfig:
    return CaptionerConfig(width=width, layers=layers, heads=heads,
                           vision_dim=width, num_vision_tokens=1,
                           max_len=max_len + 1, dtype=dtype)


def tokens(texts, max_len: int, device: torch.device) -> torch.Tensor:
    """``tokenizer.batch_encode`` on the device, without its trailing
    all-pad columns."""
    return torch.as_tensor(trim_padding(tokenizer.batch_encode(
        list(texts), max_len)), device=device).long()


def embedder_loss(params, cfg: CaptionerConfig, tok_q: torch.Tensor,
                  tok_d: torch.Tensor, t_sim: torch.Tensor, tau: float,
                  distill: float):
    """The JAX script's ``loss_fn``: (loss, (nce, distill term)) of query
    views tok_q [B, Tq] and documents tok_d [B, Td] against the teacher's
    cosine matrix t_sim [B, B]."""
    zq = encoder_forward(params, cfg, tok_q)      # query views [B, dim]
    zd = encoder_forward(params, cfg, tok_d)      # documents   [B, dim]
    sim = (zq @ zd.T) / tau
    targets = torch.arange(zq.shape[0], device=zq.device)
    nce = (F.cross_entropy(sim, targets)
           + F.cross_entropy(sim.T, targets)) / 2.0
    dist = torch.mean((zd @ zd.T - t_sim) ** 2)
    return nce + distill * dist, (nce, dist)


@torch.no_grad()
def eval_recall(params, cfg: CaptionerConfig, eval_sents, query_len: int,
                max_len: int, device: torch.device) -> float:
    """Query-view -> full-document retrieval recall@1 (held out)."""
    erng = np.random.default_rng(123)
    queries = [augment(s, erng) for s in eval_sents]
    zq = encoder_forward(params, cfg, tokens(queries, query_len, device))
    zd = encoder_forward(params, cfg, tokens(eval_sents, max_len, device))
    pred = (zq @ zd.T).argmax(dim=1).cpu().numpy()
    return float((pred == np.arange(len(eval_sents))).mean())


def hash_recall(teacher: HashedNGramEmbedder, eval_sents) -> float:
    """The hash teacher's recall@1 on the same protocol."""
    erng = np.random.default_rng(123)
    hq = teacher.embed([augment(s, erng) for s in eval_sents])
    hd = teacher.embed(eval_sents)
    return float(((hq @ hd.T).argmax(1)
                  == np.arange(len(eval_sents))).mean())


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--max-len", type=int, default=384,
                    help="document-tower byte length (queries use 96)")
    ap.add_argument("--query-len", type=int, default=96)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tau", type=float, default=0.05)
    ap.add_argument("--distill", type=float, default=4.0,
                    help="weight of the hash-teacher similarity MSE")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="checkpoints/text_embedder.npz")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = use_device(args.device)

    sents = load_sentences(args.corpus)
    rng = np.random.default_rng(args.seed)
    rng.shuffle(sents)
    n_eval = max(16, len(sents) // 10)
    eval_sents, train_sents = sents[:n_eval], sents[n_eval:]
    print(f"corpus: {len(train_sents)} train / {len(eval_sents)} eval "
          f"sentences")

    cfg = encoder_config(args.width, args.layers, args.heads, args.max_len)
    params = trainable(init_encoder_params(cfg, args.dim, args.seed,
                                           device))
    teacher = HashedNGramEmbedder(dim=args.dim)

    sched = cosine_decay_schedule(args.lr, args.steps, 0.1)
    opt = AdamW(params, sched, weight_decay=1e-4)

    def recall() -> float:
        return eval_recall(params, cfg, eval_sents, args.query_len,
                           args.max_len, device)

    # hash-teacher baseline on the same protocol
    hash_r = hash_recall(teacher, eval_sents)
    print(f"hash-teacher eval recall@1: {hash_r:.3f}")

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    clock = StepClock(device)
    losses, recalls = [], []
    t0 = time.time()
    for it in range(args.steps):
        if it == 1:
            clock.start()           # step 0 carries the warm-up
        batch = [train_sents[i] for i in
                 rng.integers(0, len(train_sents), args.batch)]
        queries = [augment(s, rng) for s in batch]
        tok_q = tokens(queries, args.query_len, device)
        tok_d = tokens(batch, args.max_len, device)
        t_emb = teacher.embed(batch)
        t_sim = torch.as_tensor(t_emb @ t_emb.T, device=device)
        opt.zero_grad()
        loss, (nce, dist) = embedder_loss(params, cfg, tok_q, tok_d, t_sim,
                                          args.tau, args.distill)
        loss.backward()
        opt.update()
        losses.append(loss.detach())
        if it % 50 == 0 or it == args.steps - 1:
            clock.stop()
            r = recall()
            recalls.append((it, r))
            print(f"step {it:4d} loss={loss.item():.4f} "
                  f"nce={nce.item():.4f} distill={dist.item():.5f} "
                  f"eval recall@1={r:.3f} ({time.time()-t0:.0f}s)")
            clock.start()
    clock.stop()
    losses = torch.stack(losses).tolist()

    final = recall()
    out = save_params(params, args.out)
    meta = {"width": args.width, "layers": args.layers, "heads": args.heads,
            "dim": args.dim, "max_len": args.max_len,
            "eval_recall_at_1": final, "hash_recall_at_1": hash_r,
            "steps": args.steps, "corpus": args.corpus}
    Path(out).with_suffix(".json").write_text(json.dumps(meta, indent=2))
    print(f"saved {out}; eval recall@1 {final:.3f} (hash {hash_r:.3f})")
    rec = {**meta,
           "device": torch.cuda.get_device_name(device) if cuda else "cpu",
           "batch": args.batch, "first_loss": losses[0],
           "last_loss": losses[-1], "recalls": recalls,
           "step_ms": clock.ms_per_step(args.steps - 1),
           "peak_memory_gb": (torch.cuda.max_memory_allocated(device)
                              / 2 ** 30 if cuda else None)}
    print(json.dumps(rec))
    return {**rec, "losses": losses}


if __name__ == "__main__":
    main()
