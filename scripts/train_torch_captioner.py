#!/usr/bin/env python3
"""Train the on-device captioner on synthetic scenes with the PyTorch port.

Counterpart of ``scripts/train_captioner.py``: synthetic coloured-shape
frames are captioned by the deterministic ``LocalVLMClient`` (frame
statistics -> text), and the ViT + captioner stack
(``models/train.py::TrainState``) learns to reproduce those captions from
pixels.  Writes an npz checkpoint ``{"vit": ..., "cap": ...}`` in the JAX
package's format, which ``TPUVLMClient`` of either package loads.

    python3 scripts/train_torch_captioner.py --steps 300 --batch 16 \\
        --out checkpoints/captioner_tiny.npz

``--device`` defaults to ``cuda`` and raises where there is no card
(``--cpu`` is ``--device cpu``).
"""
from __future__ import annotations

import argparse
import asyncio
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from vidgraph_tpu_torch.core.platform import use_device  # noqa: E402


def make_dataset(n: int, image_size: int, seed: int = 0):
    """(frames [n,S,S,3] u8, captions [n] str) of single-color scenes."""
    from vidgraph_tpu_torch.services.vlm_client import LocalVLMClient

    rng = np.random.default_rng(seed)
    colors = {"red": (220, 40, 40), "green": (40, 200, 60),
              "blue": (40, 80, 220), "yellow": (230, 220, 40),
              "magenta": (210, 40, 200), "cyan": (40, 210, 210)}
    vlm = LocalVLMClient()
    frames = np.zeros((n, image_size, image_size, 3), np.uint8)
    captions = []
    names = list(colors)
    for i in range(n):
        color = names[i % len(names)]
        s = image_size // 2
        x0 = rng.integers(0, image_size - s)
        y0 = rng.integers(0, image_size - s)
        frames[i, y0:y0 + s, x0:x0 + s] = colors[color]
        captions.append(asyncio.run(vlm.caption([frames[i]])))
    return frames, captions


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dataset", type=int, default=96)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--out", default="checkpoints/captioner_tiny.npz")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    args = ap.parse_args(argv)
    device = use_device("cpu" if args.cpu else args.device)

    from vidgraph_tpu_torch.models.captioner import CaptionerConfig, generate
    from vidgraph_tpu_torch.models.checkpoint import save_params
    from vidgraph_tpu_torch.models.tokenizer import batch_encode, decode
    from vidgraph_tpu_torch.models.train import TrainState
    from vidgraph_tpu_torch.models.vit import ViTConfig
    from vidgraph_tpu_torch.ops.preprocess import preprocess_frames

    image_size = 64
    vit_cfg = ViTConfig(image_size=image_size, patch_size=32, width=128,
                        layers=4, heads=4, embed_dim=64, dtype=torch.float32)
    cap_cfg = CaptionerConfig(width=128, layers=4, heads=4, vision_dim=64,
                              num_vision_tokens=4,
                              max_len=args.max_len + 8, dtype=torch.float32)
    state = TrainState.create(vit_cfg, cap_cfg, device,
                              learning_rate=args.lr)

    frames, captions = make_dataset(args.dataset, image_size)
    pixels = preprocess_frames(torch.as_tensor(frames, device=device),
                               size=image_size).float().cpu().numpy()
    tokens = batch_encode(captions, args.max_len)

    rng = np.random.default_rng(0)
    losses: List[float] = []
    for step in range(args.steps):
        idx = rng.integers(0, len(captions), size=args.batch)
        imgs, toks = state.shard_batch(pixels[idx], tokens[idx])
        state, loss = state.step(imgs, toks)
        losses.append(loss)
        if step % 50 == 0:
            print(f"step {step:4d}  loss {loss:.4f}")
    print(f"trained {args.steps} steps: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")

    save_params(state.checkpoint_tree(), args.out)
    print(f"checkpoint saved to {args.out}")

    # sample generation from a training image
    with torch.no_grad():
        emb = state.vit(torch.as_tensor(pixels[:1], device=device))
        vis = emb[:, None, :].expand(-1, cap_cfg.num_vision_tokens, -1)
        toks_out = generate(state.params["cap"], cap_cfg, vis.contiguous(),
                            max_new=64, flash=False).cpu().numpy()
    sample = decode(toks_out[0])
    print("target :", captions[0][:70])
    print("sample :", sample[:70])
    return {"losses": losses, "sample": sample, "target": captions[0],
            "device": str(device)}


if __name__ == "__main__":
    main()
