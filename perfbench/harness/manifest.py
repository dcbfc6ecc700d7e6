"""``BENCHMARK.json`` and the files it names by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Everything else is found by name under ``perfbench/``:

| piece                          | file                                  |
|--------------------------------|---------------------------------------|
| configuration                  | ``configs/<config>.json`` (its ``file``) |
| traffic mix                    | ``traffic/<traffic>.json``            |
| run of the mix's ``kind``      | ``harness/<kind>.py``                 |
| limits of the compared numbers | ``limits/<workload>.json``            |
| per-layer metric reader        | ``layer_metrics/<metric>.py``         |
| peaks of the card              | ``peaks.json``                        |
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def harness(self):
        """``harness/<kind>.py`` of the cell's traffic mix: its ``run``
        and ``control``."""
        return importlib.import_module(
            f"perfbench.harness.{self.traffic['kind']}")


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> Dict:
    return _load_json(root / "BENCHMARK.json")


def _reported(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic mix, limits and
    the metrics it reports."""
    bench = manifest(root)
    try:
        entry = next(w for w in bench["workloads"] if w["name"] == name)
    except StopIteration:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json") from None
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    limits = _load_json(BENCH / "limits" / f"{name}.json")
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=_load_json(root / conf["file"]),
        traffic=_load_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        limits={k: float(v["limit"]) for k, v in limits.items()},
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)])


def peaks() -> Dict[str, float]:
    return _load_json(BENCH / "peaks.json")


def reader(metric: str) -> Callable[[Dict], object]:
    """The ``read(ctx)`` of ``layer_metrics/<metric>.py``."""
    path = BENCH / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_layer_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
