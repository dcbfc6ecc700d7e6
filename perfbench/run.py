"""The benchmark of ``vidgraph_tpu_torch`` on one H100: one cell of
``BENCHMARK.json``, one JSON result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell's configuration, traffic mix,
limits and per-layer readers are found by name (``harness/manifest.py``).
Set-up, the measured window and the comparison with the plain reference
are those of the kind of traffic the mix names (``harness/<kind>.py``).
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from spans, counters and a
device trace of part of the window.

The last line of standard output is the result; each compared number and
its limit are also the last lines of standard error.  The run fails, and
prints no result, without a CUDA card (or with fewer than the cell asks
for), without the port beside it, or when JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness.trace import SetupClock, process_age  # noqa: E402

AGE0 = process_age()
FORBIDDEN = ("jax", "jaxlib", "flax", "vidgraph_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole: ``vidgraph_tpu_torch`` is not one)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _fail(message: str) -> int:
    print(f"perfbench: {message}", file=sys.stderr)
    return 1


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout; the port builds
    its own library into ``build/kernels/`` beside its sources."""
    cache = ROOT / "build" / "perfbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def result_line(cell, out: dict, trace: bool, device) -> dict:
    import torch

    from perfbench.harness import compare, manifest
    from perfbench.harness.trace import top

    checks = compare.verdict(out["numbers"], cell.limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": compare.passed(checks) and out["failed"] == 0,
            "attempted": int(out["attempted"]), "failed": int(out["failed"]),
            "metrics": {}, "device": dev}
    if not trace:
        for m in cell.end_to_end:
            line["metrics"][m["name"]] = {
                "value": float(out["end_to_end"][m["name"]]),
                "unit": m["unit"]}
    else:
        traced = out["trace"].read()
        dev["busy_s"] = traced["busy_s"]
        dev["window_s"] = traced["window_s"]
        ctx = {"config": cell.config, "traffic": cell.traffic,
               "peaks": manifest.peaks(), "spans": out["spans"],
               "counters": out["counters"], "trace": traced}
        for m in cell.per_layer:
            value = manifest.reader(m["name"])(ctx)
            if value is not None:
                line["metrics"][m["name"]] = {"value": float(value),
                                              "unit": m["unit"]}
        line["breakdown"] = {"device_ops": top(traced["ops_s"]),
                             "idle_gaps": top(traced["gaps_s"])}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()

    import torch

    clock = SetupClock(AGE0, T0)
    clock.mark("torch")
    if not torch.cuda.is_available():
        return _fail("no CUDA card: torch.cuda.is_available() is false")
    from perfbench.harness import manifest

    try:
        cell = manifest.cell(args.workload)
    except (OSError, KeyError, StopIteration, ValueError) as e:
        return _fail(f"cannot load workload {args.workload!r}: {e}")
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{args.workload} needs {cell.chips} cards, "
                     f"{torch.cuda.device_count()} found")
    try:
        import vidgraph_tpu_torch  # noqa: F401
    except ImportError as e:
        return _fail(f"the port vidgraph_tpu_torch does not import: {e}")
    clock.mark("port")
    device = torch.device("cuda:0")
    os.environ["VIDGRAPH_TORCH_DEVICE"] = "cuda:0"
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    clock.mark("cuda")
    run = cell.harness.run(cell, args.seed, args.seconds, bool(args.trace),
                           clock, device)
    found = forbidden_modules()
    if found:
        return _fail(f"JAX was loaded in the benchmark's process: {found}")
    line = result_line(cell, run, bool(args.trace), device)
    print("setup stages (s): " + ", ".join(
        f"{name} {t:.3f}" for name, t in clock.stages), file=sys.stderr)
    print("window: " + json.dumps({k: v for k, v in run["counters"].items()
                                   if k != "step_ms"}), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
