#!/usr/bin/env python3
"""Mid-scale (204M) LM training run of the PyTorch port on one CUDA card.

Counterpart of ``scripts/train_midscale.py``: a few hundred steps at a
16 x 1024 decoder (GPT-2-medium-class shapes) with a finite, falling loss,
the measured train-step MFU (model FLOPs / step time / the H100's 989
TFLOP/s dense bf16 peak, NVIDIA's data sheet for the SXM part), and a bf16
checkpoint round trip.  The data is the byte-level caption corpus (the
captions' sentences plus synthetic scene sentences) packed into fixed
windows: the point is the systems measurement, not a new model.

  python3 scripts/train_torch_midscale.py \\
      --corpus vlm_output.json --steps 300 --flash \\
      --out checkpoints/midscale_lm.npz

``--flash`` trains through the hand-written CUDA FlashAttention kernels
with remat off by default; without it the masked einsum needs remat at
this scale (it materialises the [B, h, T, T] probabilities).  ``--device``
defaults to ``cuda`` and raises where there is no card; ``--smoke`` is a
tiny config and does not choose the device.  Prints one JSON line:
params, tokens/s, step_ms, mfu and the peak it divides by, peak device
memory, first and last loss, the round trip's status.
"""
from __future__ import annotations

import argparse
import json
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
    generate_from_tokens, init_params, quantize_params)
from vidgraph_tpu_torch.models.checkpoint import (  # noqa: E402
    load_params, save_params, tree_leaves)
from vidgraph_tpu_torch.models.train import (  # noqa: E402
    AdamW, masked_cross_entropy, warmup_cosine_decay_schedule)

H100_BF16_PEAK = 989e12     # dense bf16 FLOP/s, H100 SXM data sheet


def mid_config(seq_len: int) -> CaptionerConfig:
    """~204M params: 16 x 1024 decoder (GPT-2-medium-class shapes)."""
    return CaptionerConfig(width=1024, layers=16, heads=16,
                           max_len=seq_len + 64)


def pack_corpus(captions, seq_len: int, rng: random.Random) -> np.ndarray:
    """Byte-tokenize the corpus into packed [N, seq_len+1] windows."""
    sents = instruct_data.sentences_of(captions) + [
        instruct_data.synth_sentence(rng) for _ in range(4000)]
    rng.shuffle(sents)
    stream: list = []
    for s in sents:
        stream.extend(tokenizer.encode(s, add_bos=True, add_eos=True))
    n = len(stream) // (seq_len + 1)
    arr = np.asarray(stream[:n * (seq_len + 1)],
                     np.int32).reshape(n, seq_len + 1)
    return arr


def train_flops_per_token(cfg: CaptionerConfig, seq: int) -> float:
    """6N per token for fwd+bwd on the dense params, plus the attention
    score/value matmuls 12*L*s*d (fwd 4*s*d per layer-token, x3 for bwd)."""
    return 6.0 * cfg.num_params + 12.0 * cfg.layers * seq * cfg.width


def lm_loss(params: Dict, cfg: CaptionerConfig, batch: torch.Tensor,
            remat: bool, flash: bool) -> torch.Tensor:
    """Next-byte cross entropy of packed windows ``batch`` [B, L+1]."""
    inputs, targets = batch[:, :-1].long(), batch[:, 1:]
    vis = torch.zeros((inputs.shape[0], cfg.num_vision_tokens,
                       cfg.vision_dim), dtype=torch.float32,
                      device=inputs.device)
    logits = forward(params, cfg, vis, inputs, remat=remat, flash=flash)
    return masked_cross_entropy(logits, targets,
                                targets != tokenizer.PAD_ID)


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="checkpoints/midscale_lm.npz")
    ap.add_argument("--flash", action="store_true",
                    help="FlashAttention (CUDA kernels, forward and "
                         "backward): one float32 per row kept for the "
                         "backward, so remat defaults OFF")
    ap.add_argument("--remat", action="store_true",
                    help="force block rematerialisation (always on for "
                         "the non-flash path at this scale)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny config (wiring check)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = use_device(args.device)
    rng = random.Random(args.seed)

    data = json.loads(Path(args.corpus).read_text())
    captions = [r.get("content", "") for r in data["results"]
                if r.get("content")]
    if args.smoke:
        args.steps, args.batch, args.seq_len = 6, 2, 128
        captions = captions[:20]

    cfg = (CaptionerConfig(width=64, layers=2, heads=2,
                           max_len=args.seq_len + 64)
           if args.smoke else mid_config(args.seq_len))
    print(f"config: {cfg.layers}x{cfg.width}, "
          f"{cfg.num_params / 1e6:.1f}M params")

    toks = pack_corpus(captions, args.seq_len, rng)
    print(f"corpus: {toks.shape[0]} windows of {args.seq_len + 1}")

    params = init_params(cfg, args.seed,
                         device=device, requires_grad=True)
    sched = warmup_cosine_decay_schedule(
        0.0, args.lr, warmup_steps=max(1, args.steps // 10),
        decay_steps=args.steps, end_value=args.lr * 0.1)
    opt = AdamW(params, sched, weight_decay=0.01, max_norm=1.0)

    # the remat decision comes from whether flash ENGAGES on this device;
    # the einsum path at 204M/1024 needs remat (it keeps the materialised
    # attention probabilities of every layer otherwise)
    flash = flash_engaged(args.flash, device)
    remat = args.remat or not flash
    print(f"device {device}; attention: {'flash' if flash else 'einsum'}, "
          f"remat={remat}")

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    nrng = np.random.default_rng(args.seed)
    losses: List[float] = []
    t_timed = 0.0
    timed_steps = 0
    t0 = time.time()
    for step in range(args.steps):
        idx = nrng.integers(0, toks.shape[0], size=args.batch)
        batch = torch.as_tensor(toks[idx], device=device)
        ts = time.perf_counter()
        opt.zero_grad()
        loss_t = lm_loss(params, cfg, batch, remat, flash)
        loss_t.backward()
        opt.update()
        loss = loss_t.item()    # fetch -> waits for the device
        dt = time.perf_counter() - ts
        if step == 0:
            print(f"step 0  loss {loss:.4f}  (first step {dt:.1f}s)")
        else:
            t_timed += dt
            timed_steps += 1
        losses.append(loss)
        if step % 50 == 0 and step:
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"({timed_steps / t_timed:.2f} it/s)")
    wall = time.time() - t0

    step_s = t_timed / max(1, timed_steps)
    tokens_per_step = args.batch * args.seq_len
    tok_s = tokens_per_step / step_s
    # an MFU is a statement about the card: none from a host run
    mfu = ((train_flops_per_token(cfg, args.seq_len) * tok_s)
           / H100_BF16_PEAK if cuda else None)
    peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else None

    # ---- bf16 checkpoint round-trip -------------------------------------
    with torch.no_grad():
        bf16 = quantize_params(params, torch.bfloat16)
    save_params(bf16, args.out)
    reloaded = load_params(bf16, args.out)
    roundtrip = all(torch.equal(a, b) for (_, a), (_, b)
                    in zip(tree_leaves(bf16), tree_leaves(reloaded)))
    # and the reloaded bf16 weights must decode
    prompt = tokenizer.encode("The scene shows", add_bos=True, add_eos=False)
    arr = np.full((1, 64), tokenizer.PAD_ID, np.int32)
    arr[0, :len(prompt)] = prompt
    sample = tokenizer.decode(generate_from_tokens(
        reloaded, cfg, torch.as_tensor(arr, device=device), len(prompt),
        max_new=32, flash=flash)[0].cpu().numpy())
    meta = {"config": f"{cfg.layers}x{cfg.width}",
            "params_m": round(cfg.num_params / 1e6, 1),
            "steps": args.steps, "batch": args.batch,
            "seq_len": args.seq_len,
            "attention": "flash" if flash else "einsum",
            "remat": remat,
            "device": (torch.cuda.get_device_name(device) if cuda
                       else "cpu"),
            "first_loss": round(losses[0], 4),
            "last_loss": round(losses[-1], 4),
            "step_ms": round(step_s * 1e3, 1),
            "tokens_per_sec": int(tok_s),
            "train_mfu": round(mfu, 4) if cuda else None,
            "mfu_peak_flops": H100_BF16_PEAK,
            "mfu_peak": "H100 SXM dense bf16, 989 TFLOP/s",
            "peak_memory_gb": (round(peak_bytes / 2 ** 30, 2) if cuda
                               else None),
            "wall_s": round(wall, 1),
            "bf16_roundtrip_exact": bool(roundtrip),
            "decode_sample": sample[:80]}
    Path(args.out).with_suffix(".json").write_text(json.dumps(meta))
    print(json.dumps(meta))
    return {**meta, "losses": losses}


if __name__ == "__main__":
    main()
