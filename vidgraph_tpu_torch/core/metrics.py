"""In-memory run metrics: timings, counts, per-batch metric dicts.

Parity with reference src/core/metrics.py:9-65 (record_timing / record_count /
add_batch_metrics / get_summary / save_metrics) with identical JSON layout so
the reference's plotting tools keep working.
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List

from .logger import get_logger

logger = get_logger("metrics")


class MetricsTracker:
    def __init__(self) -> None:
        self.timings: Dict[str, List[float]] = defaultdict(list)
        self.counts: Dict[str, int] = defaultdict(int)
        self.batch_metrics: List[Dict[str, Any]] = []

    def record_timing(self, name: str, seconds: float) -> None:
        self.timings[name].append(float(seconds))

    def record_count(self, name: str, value: int = 1) -> None:
        self.counts[name] += int(value)

    def add_batch_metrics(self, metrics: Dict[str, Any]) -> None:
        self.batch_metrics.append(dict(metrics))

    def get_summary(self) -> Dict[str, Any]:
        summary: Dict[str, Any] = {"counts": dict(self.counts), "timings": {}}
        for name, values in self.timings.items():
            if values:
                summary["timings"][name] = {
                    "count": len(values),
                    "total": sum(values),
                    "average": sum(values) / len(values),
                    "min": min(values),
                    "max": max(values),
                }
        return summary

    def save_metrics(self, path: str) -> None:
        out = {
            "summary": self.get_summary(),
            "batch_metrics": self.batch_metrics,
        }
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "w") as f:
            json.dump(out, f, indent=2, default=str)
        logger.info("Saved metrics to %s", path)
