"""The comparisons that decide ``correct``: each number the program's
outputs give against the plain reference, beside its limit."""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[List[str]] = None) -> float:
    """The worst leaf's gap of norms: ``|prog - ref| / max(ref, median
    ref)`` over the leaves in ``keep`` (every leaf when None)."""
    keys = list(ref) if keep is None else keep
    median = statistics.median(ref[k] for k in ref)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
               for k in keys)


def token_gaps(logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """[n] gaps by which each served token's logit lies below the best
    logit at its position: ``logits`` [n, vocab], ``served`` [n]."""
    best = logits.max(dim=-1).values
    return best - logits.gather(-1, served.long()[:, None])[:, 0]


def served_length(tokens: torch.Tensor, eos: int) -> int:
    """Tokens a row served: up to and with its first EOS."""
    hits = (tokens == eos).nonzero()
    return int(hits[0]) + 1 if len(hits) else int(tokens.shape[0])


def decode_bytes(tokens, eos: int) -> str:
    """The caption text of a row of byte tokens: the bytes before the
    first EOS, UTF-8 with replacement."""
    out = bytearray()
    for t in tokens:
        t = int(t)
        if t == eos:
            break
        if t < 256:
            out.append(t)
    return out.decode("utf-8", errors="replace")


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, Dict[str, float]]:
    """``{name: {"value": x, "limit": y}}`` for every limit; a number that
    was not read is NaN, which fails."""
    return {k: {"value": float(numbers.get(k, float("nan"))),
                "limit": float(limit)} for k, limit in limits.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"]
                                for c in checks.values())
