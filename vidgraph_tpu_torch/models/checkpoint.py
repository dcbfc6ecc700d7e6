"""Model checkpointing in the JAX package's format.

Counterpart of ``vidgraph_tpu/models/checkpoint.py``: a flat ``.npz`` whose
keys are the '/'-joined paths of a nested dict/list parameter tree
(``blocks/0/qkv_w``), with bfloat16 leaves stored as their uint16 bit
patterns under ``__bf16__/``.  Either package reads what the other writes,
bit for bit.  The writer goes through a temporary file and ``os.replace``,
so a reader never sees a half-written checkpoint.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_BF16_PREFIX = "__bf16__/"


def tree_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs of a nested dict/list tree, keys '/'-joined
    (``blocks/0/qkv_w``); anything else, a ``Q8`` included, is a leaf."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from tree_leaves(v, f"{prefix}/{k}" if prefix else k)


def _rebuild(tree: Any, fn, prefix: str = "") -> Any:
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, key(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, key(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def to_numpy(t: torch.Tensor) -> Tuple[bool, np.ndarray]:
    """(is_bf16, host array); a bfloat16 tensor comes back as its uint16
    bit patterns."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return True, t.view(torch.int16).numpy().view(np.uint16)
    return False, t.numpy()


def from_numpy(arr: np.ndarray, bf16: bool) -> torch.Tensor:
    """Inverse of :func:`to_numpy`."""
    # ascontiguousarray makes a 0-d array (a saved step count) 1-d
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
    if bf16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def save_params(params: Any, path: str) -> str:
    flat: Dict[str, np.ndarray] = {}
    for key, leaf in tree_leaves(params):
        bf16, arr = to_numpy(torch.as_tensor(leaf))
        flat[(_BF16_PREFIX + key) if bf16 else key] = arr
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(f".{p.name}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, p)
    return str(p)


def load_params(template: Any, path: str,
                device: Optional[torch.device] = None) -> Any:
    """Load into the structure of ``template``: shapes must match; each
    leaf takes its template leaf's dtype, and ``device`` (default: the
    template leaf's device)."""
    with np.load(path) as data:
        flat = {}
        for k in data.files:
            if k.startswith(_BF16_PREFIX):
                flat[k[len(_BF16_PREFIX):]] = from_numpy(data[k], True)
            else:
                flat[k] = from_numpy(data[k], False)

    def load(key: str, leaf: torch.Tensor) -> torch.Tensor:
        if key not in flat:
            raise KeyError(f"checkpoint missing parameter: {key}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: checkpoint "
                             f"{tuple(arr.shape)} vs template "
                             f"{tuple(leaf.shape)}")
        return arr.to(device=device or leaf.device, dtype=leaf.dtype)
    return _rebuild(template, load)
