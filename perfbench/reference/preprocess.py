"""Plain reference of frame preprocessing: uint8 frames -> an antialiased
bilinear (triangle-filter) resize to S x S -> CLIP's normalisation.

    out[c] = (resize(x)[c] / 255 - mean_c) / std_c

The resize is separable: rows by ``interp_matrix(S, H)``, columns by
``interp_matrix(S, W)``, each row of weights a triangle of half-width
max(1, scale) around the source centre, normalised to sum 1.  In float32;
``rnd`` rounds the resize products' operands and the result
(``lowp.py``).  CLIP's statistics are public constants.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .lowp import exact

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def interp_matrix(dst: int, src: int) -> np.ndarray:
    """[dst, src] antialiased bilinear interpolation weights."""
    scale = src / dst
    support = max(1.0, scale)
    out = np.zeros((dst, src), np.float64)
    centers = (np.arange(dst) + 0.5) * scale - 0.5
    for i, center in enumerate(centers):
        lo = max(0, int(np.floor(center - support)))
        hi = min(src - 1, int(np.ceil(center + support)))
        j = np.arange(lo, hi + 1)
        w = np.maximum(0.0, 1.0 - np.abs(j - center) / support)
        if w.sum() > 0:
            out[i, lo:hi + 1] = w / w.sum()
    return out.astype(np.float32)


def preprocess(frames_u8: torch.Tensor, size: int,
               rnd: Callable[[torch.Tensor], torch.Tensor] = exact
               ) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, size, size, 3] float32."""
    _, h, w, _ = frames_u8.shape
    dev = frames_u8.device
    rh = torch.from_numpy(interp_matrix(size, h)).to(dev)
    rw = torch.from_numpy(interp_matrix(size, w)).to(dev)
    x = frames_u8.float()
    y = torch.einsum("hs,bswc->bhwc", rnd(rh), rnd(x))
    y = torch.einsum("vw,bhwc->bhvc", rnd(rw), rnd(y))
    mean = torch.tensor(CLIP_MEAN, device=dev)
    std = torch.tensor(CLIP_STD, device=dev)
    return rnd((y / 255.0 - mean) / std)
