"""Bytes a KV-cached decode step of the captioner needs, under the
counting rules of ``attention_fwd.py`` (each input or output byte once;
causal attention at its half, which here means the attended slots only):
every weight read once a step, the cache's K and V of the slots the step
attends over (the prompt's and the decode's written slots, not the cache's
unwritten tail) read once, and the step's new K and V written once, in the
configuration's compute type.  Embedding rows, layer norms, biases and
activations are left out: they are under a thousandth of the rest at the
sizes the benchmark runs.
"""
from __future__ import annotations

from typing import Dict

ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def weight_bytes(sizes: Dict) -> int:
    """The block matrices and the head, in the parameter type."""
    d, elem = sizes["width"], ELEM[sizes["param_dtype"]]
    return (sizes["layers"] * 12 * d * d + d * sizes["vocab"]) * elem


def step_bytes(sizes: Dict, batch: int, slots: int) -> int:
    """One step of ``batch`` rows attending over ``slots`` cache slots
    (the new one included)."""
    kv = ELEM[sizes["dtype"]] * 2 * sizes["layers"] * sizes["width"] * batch
    return weight_bytes(sizes) + kv * slots + kv


def decode_bytes(sizes: Dict, batch: int, prompt: int, steps: int) -> int:
    """``steps`` steps after a prompt of ``prompt`` slots: step i attends
    over ``prompt + i + 1`` slots."""
    return sum(step_bytes(sizes, batch, prompt + i + 1)
               for i in range(steps))
