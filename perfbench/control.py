"""Readings that set the limits of a cell's compared numbers: the
program's on many seeds, the control's (the reference in the precision
below the configuration's, in the program's place) and the program's with
a fault planted (``harness/faults.py``).  Not part of a benchmark run.

    python3 perfbench/control.py --workload <name> --seconds <s> \\
        --seeds S1 S2 ... [--control-seeds S ...] [--faults unchanged ...] \\
        [--out FILE]

One process on one card: each seed builds the cell anew (its weights come
from the seed), runs a window of ``--seconds`` as ``run.py`` does, and
prints one JSON line of readings per seed and kind (``program``,
``control``, ``fault:<name>``), also appended to ``--out``.  The control
and the faults run on the control seeds.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import os

    import torch

    from perfbench.harness import manifest
    from perfbench.harness.faults import planted
    from perfbench.harness.trace import SetupClock

    if not torch.cuda.is_available():
        print("perfbench: no CUDA card", file=sys.stderr)
        return 1
    os.environ["VIDGRAPH_TORCH_DEVICE"] = "cuda:0"
    device = torch.device("cuda:0")

    def emit(record):
        line = json.dumps(record)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def run(cell, seed, seconds, keep=False):
        t = time.perf_counter()
        return cell.harness.run(cell, seed, seconds, False,
                                SetupClock(0.0, t), device, keep=keep)

    for seed in args.seeds:
        cell = manifest.cell(args.workload)
        t = time.perf_counter()
        out = run(cell, seed, args.seconds, keep=True)
        emit({"workload": cell.name, "seed": seed, "kind": "program",
              "numbers": out["numbers"], "setup_s": out["setup_s"],
              "seconds": time.perf_counter() - t})
        if seed in args.control_seeds:
            t = time.perf_counter()
            nums = cell.harness.control(cell, seed, out, device)
            emit({"workload": cell.name, "seed": seed, "kind": "control",
                  "numbers": nums, "seconds": time.perf_counter() - t})
        del out
        for fault in args.faults if seed in args.control_seeds else ():
            t = time.perf_counter()
            with planted(fault):
                out = run(cell, seed, 0.0)
            emit({"workload": cell.name, "seed": seed,
                  "kind": f"fault:{fault}", "numbers": out["numbers"],
                  "seconds": time.perf_counter() - t})
            del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
