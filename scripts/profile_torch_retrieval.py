"""Where the time goes in the PyTorch port's bench-scale retrieval, on one
CUDA card.

    python3 scripts/profile_torch_retrieval.py [--passes 2] [--out DIR]

Builds ``bench.py``'s reference-scale graph (600 entities, 326 chunks,
1,600 relations) with the port's store and embedder on the card, runs its
5 warm-up queries, then runs its 30 queries ``--passes`` times under
``torch.profiler`` (CPU and CUDA activities).  For each pass it prints one
JSON line: the wall time (profiler included), the device's busy time (the
union of the intervals of its kernels, copies and memsets) and busy share,
and the device time by op.  The full ``key_averages`` tables go to
``DIR/profile_torch_retrieval.txt`` (default ``chiprun_out``).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def device_busy_us(events) -> float:
    """Length of the union of the device events' time ranges, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_retrieval: needs a CUDA card", file=sys.stderr)
        return 1
    sys.modules["tiktoken"] = None   # its encoder would be fetched
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["VIDGRAPH_TORCH_DEVICE"] = "cuda"
    import bench
    from chip_smoke import bench_retriever

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    retriever, _, queries = bench_retriever("cuda")

    async def run(qs):
        for q in qs:
            await retriever.perform_hybrid_retrieval(q)

    asyncio.run(run(queries[:bench.WARMUP]))
    torch.cuda.synchronize()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tables = []
    for p in range(args.passes):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            asyncio.run(run(queries))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        by_op = defaultdict(lambda: [0, 0.0])
        for e in dev:
            by_op[e.name][0] += 1
            by_op[e.name][1] += e.time_range.end - e.time_range.start
        busy_ms = device_busy_us(dev) / 1e3
        print(json.dumps({
            "pass": p, "card": card, "queries": len(queries),
            "wall_ms": wall_ms, "ms_per_query": wall_ms / len(queries),
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "device_us_by_op": {
                name: {"calls": n, "us": us} for name, (n, us) in sorted(
                    by_op.items(), key=lambda kv: -kv[1][1])[:12]}}),
            flush=True)
        tables.append(prof.key_averages().table(
            sort_by="self_cpu_time_total", row_limit=40))
    (out / "profile_torch_retrieval.txt").write_text(
        f"{card}\n\n" + "\n\n".join(tables))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
