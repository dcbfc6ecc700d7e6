"""The one generator of traffic: what a mix file's numbers ask for, drawn
from the seed.

* ``frame_pool``: chunks of camera-like frames, a square of a colour
  moving along a sine over dark noise (the stream-scaling script's frames,
  at any size), made on the device in a few large calls and brought to the
  host as one array.
* ``byte_batches``: rows of printable bytes, each a prompt and a response
  right-padded to a fixed length, the way the instruct trainer packs its
  long bucket: every row's length, prompt length and bytes come from the
  seed, and every shape is the same whatever the seed.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

COLOURS = ((200, 30, 30), (30, 200, 30), (30, 30, 200), (200, 200, 30),
           (200, 30, 200), (30, 200, 200), (230, 230, 230), (120, 60, 20))


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def frame_pool(mix: Dict, seed: int, device) -> np.ndarray:
    """[pool_chunks, frames_per_chunk, H, W, 3] uint8 on the host."""
    n, f = mix["pool_chunks"], mix["frames_per_chunk"]
    h, w = mix["frame_height"], mix["frame_width"]
    g = _generator(seed, device)
    frames = torch.randint(0, 40, (n, f, h, w, 3), generator=g,
                           device=device, dtype=torch.uint8)
    colour = torch.tensor(COLOURS, dtype=torch.uint8, device=device)[
        torch.randint(0, len(COLOURS), (n,), generator=g, device=device)]
    phase = torch.rand((n,), generator=g, device=device) * 2 * np.pi
    side = h // 2
    step = torch.arange(f, device=device)
    x0 = ((w - side) * (0.5 + 0.4 * torch.sin(phase[:, None] + step / 5.0))
          ).long()                                            # [n, f]
    cols = torch.arange(w, device=device)
    in_x = (cols >= x0[..., None]) & (cols < x0[..., None] + side)
    rows = torch.arange(h, device=device)
    y0 = (h - side) // 2
    in_y = (rows >= y0) & (rows < y0 + side)
    square = in_y[None, None, :, None] & in_x[:, :, None, :]  # [n, f, h, w]
    frames = torch.where(square[..., None], colour[:, None, None, None, :],
                         frames)
    return frames.cpu().numpy()


def call_order(seed: int, pool: int, per_call: int
               ) -> Iterator[np.ndarray]:
    """The pool's chunks for each call: a seeded permutation per call."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    while True:
        yield rng.permutation(pool)[:per_call]


def byte_batches(mix: Dict, seed: int, device
                 ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """(tokens [batch, seq_len + 1] int32, prompt_lens [batch] int32) on
    ``device``, a new batch of distinct rows per step."""
    b, t = mix["batch"], mix["seq_len"]
    lo_len = int(t * mix["min_fill"])
    g = _generator(seed, device)
    pos = torch.arange(t + 1, device=device)
    while True:
        length = torch.randint(lo_len, t + 2, (b,), generator=g,
                               device=device)
        frac = mix["prompt_min"] + (mix["prompt_max"] - mix["prompt_min"]) \
            * torch.rand((b,), generator=g, device=device)
        plen = torch.clamp((length * frac).long(), min=4)
        toks = torch.randint(32, 127, (b, t + 1), generator=g, device=device,
                             dtype=torch.int32)
        toks[:, 0] = mix["bos_id"]
        toks = torch.where(pos[None] < length[:, None], toks,
                           torch.full_like(toks, mix["pad_id"]))
        yield toks, plen.to(torch.int32)


def rows_of(pool: np.ndarray, order: np.ndarray) -> List[List[np.ndarray]]:
    """The chunks of ``order`` as the client takes them: a list of frames
    per chunk (views into the pool)."""
    return [list(pool[i]) for i in order]
