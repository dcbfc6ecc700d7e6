#!/usr/bin/env python3
"""Stage-by-stage roofline of the fused preprocess + ViT frame embedding of
the PyTorch port, on one CUDA card.

Counterpart of ``scripts/profile_vit.py``: 720p uint8 frames (made with
numpy) -> antialiased resize + CLIP normalise (the CUDA preprocessing
kernel, ``ops/preprocess.py``) -> patchify -> ViT-B/32 (seed weights,
bf16) -> 512-d embeddings, at B = 160 by default.  Each stage is timed on
its own: the mean of ``reps`` back-to-back calls on the host clock,
between two synchronisations, so the work is done before the clock stops.
Rows: the fused step (resize + normalise + ViT), the preprocessing alone,
the tower on a 224 input, patchify + patch embedding, and the dispatch
floor (a trivial op on the same input); with ``--attn`` the fused step
under each ``attn_impl`` (``einsum``, ``packed``, and ``fused``, the CUDA
short-attention kernel), with the embeddings' drift from einsum's.

Each row has TFLOP/s and MFU over the H100's dense bf16 peak (989 TFLOP/s,
the SXM data sheet), and GB/s and its share of 3.35 TB/s of HBM; on the
CPU (``--device cpu``) the times are printed and the device rates are not
(None).

  python3 scripts/profile_torch_vit.py [--batch 160] [--attn]
  python3 scripts/profile_torch_vit.py --smoke --device cpu

Prints one JSON object.  ``--device`` defaults to ``cuda`` and raises
where there is no card; ``--smoke`` is B = 4 with 3 repetitions.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vidgraph_tpu_torch.core.platform import use_device  # noqa: E402
from vidgraph_tpu_torch.models.vit import (  # noqa: E402
    ViTConfig, VisionTower, init_vision_tower)
from vidgraph_tpu_torch.ops.preprocess import (patchify,  # noqa: E402
                                               preprocess_frames)

PEAK = 989e12       # H100 SXM dense bf16 FLOP/s (data sheet)
HBM = 3.35e12       # H100 SXM HBM3 bytes/s
FRAME_HW = (720, 1280)


def timeit(fn, *args, reps: int = 10) -> float:
    """Mean seconds a call over ``reps`` back-to-back calls after a
    warm-up, the device drained before each clock read."""
    cuda = torch.cuda.is_available() and any(
        isinstance(a, torch.Tensor) and a.is_cuda for a in args)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    sync()
    return (time.perf_counter() - t0) / reps


def vit_flops(cfg: ViTConfig, b: int) -> float:
    """The tower's dense FLOPs for ``b`` frames (the JAX script's count):
    the block products, attention's two products, the patch embedding
    and the output projection."""
    n_tok, d = cfg.num_patches + 1, cfg.width
    return b * (2 * n_tok * 12 * d * d * cfg.layers
                + 2 * cfg.layers * 2 * n_tok * n_tok * d
                + 2 * n_tok * (cfg.patch_size ** 2 * 3) * d
                + 2 * d * cfg.embed_dim)


def resize_flops(b: int, size: int = 224) -> float:
    """The resize as two dense interpolation products (the JAX script's
    count for its matrix resize)."""
    h, w = FRAME_HW
    return b * 2 * 3 * (size * w * h + size * size * w)


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=160)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--attn", action="store_true",
                    help="compare attention impls (einsum/packed/fused) "
                         "on the full fused step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = use_device(args.device)
    cuda = device.type == "cuda"

    cfg = ViTConfig.b32()
    b = 4 if args.smoke else args.batch
    tower = init_vision_tower(cfg, args.seed,
                              device=device).eval()
    rng = np.random.default_rng(args.seed)
    frames = torch.as_tensor(rng.integers(0, 256, size=(b, *FRAME_HW, 3),
                                          dtype=np.uint8), device=device)
    d = cfg.width
    size = cfg.image_size

    def pre(f):
        return preprocess_frames(f, size=size, fast=True)

    def fused(f):
        return tower(pre(f))

    x224 = pre(frames).clone()          # materialised tower input

    def patch_embed(x):
        return tower.patch_embed(patchify(x, cfg.patch_size).to(cfg.dtype))

    rows = []

    def add(name, dt, flops, bytes_moved):
        rows.append({
            "stage": name, "ms": dt * 1e3,
            "tflops": flops / dt / 1e12 if cuda else None,
            "mfu": flops / dt / PEAK if cuda else None,
            "gb_s": bytes_moved / dt / 1e9 if cuda else None,
            "hbm_frac": bytes_moved / dt / HBM if cuda else None,
            "bound_ms": max(flops / PEAK, bytes_moved / HBM) * 1e3,
        })

    reps = 3 if args.smoke else 10
    h, w = FRAME_HW
    vf, rf = vit_flops(cfg, b), resize_flops(b, size)
    with torch.no_grad():
        dt = timeit(fused, frames, reps=reps)
        add("fused (resize+norm+ViT)", dt, vf + rf,
            b * (h * w * 3 + 2 * size * size * 3 * 2))
        fused_ms = dt * 1e3

        dt = timeit(pre, frames, reps=reps)
        add("preprocess (resize+norm)", dt, rf,
            b * (h * w * 3                  # u8 read
                 + size * size * 3 * 2))     # out write (bf16)
        pre_ms = dt * 1e3

        dt = timeit(tower, x224, reps=reps)
        add("ViT tower (224 input)", dt, vf, b * size * size * 3 * 2)
        tower_ms = dt * 1e3

        dt = timeit(patch_embed, x224, reps=reps)
        add("patchify+patch_embed", dt,
            b * 2 * cfg.num_patches * (cfg.patch_size ** 2 * 3) * d,
            b * (size * size * 3 * 2 + cfg.num_patches * d * 2))

        dt = timeit(lambda f: f[0, 0, 0, :].float() * 2.0, frames,
                    reps=reps)
        rows.append({"stage": "dispatch floor (trivial op)",
                     "ms": dt * 1e3})

        attn_rows = []
        if args.attn:
            ref_emb = None
            for impl in ("einsum", "packed", "fused"):
                itower = VisionTower(dataclasses.replace(
                    cfg, attn_impl=impl)).to(device).eval()
                itower.load_state_dict(tower.state_dict())

                def ifused(f, m=itower):
                    return m(pre(f))

                dt = timeit(ifused, frames, reps=reps)
                emb = ifused(frames).float().cpu().numpy()
                if ref_emb is None:
                    ref_emb = emb
                attn_rows.append({
                    "impl": impl, "ms": dt * 1e3,
                    "mfu": (vf + rf) / dt / PEAK if cuda else None,
                    "max_abs_drift_vs_einsum": float(
                        np.max(np.abs(emb - ref_emb)))})

    rec = {"batch": b, "frames": f"{h}x{w} uint8 -> {size} bf16",
           "device": torch.cuda.get_device_name(device) if cuda else "cpu",
           "peak_flops": PEAK, "hbm_bytes_s": HBM,
           "fused_ms": fused_ms, "sum_parts_ms": pre_ms + tower_ms,
           "stages": rows, **({"attn_impls": attn_rows} if attn_rows else {})}
    print(json.dumps(rec, indent=2))
    return rec


if __name__ == "__main__":
    main()
