"""A traced run of one cell with the port's own spans: the result line of
``run.py --trace 1``, with the per-layer metrics that read the port's
tracer (``vidgraph_tpu_torch/core/profiling.py``), the device's idle time
by the innermost span open over it, and the check of the shared clock.

    python3 perfbench/program_spans.py --workload <name> --seed <n> \\
        --seconds <s> [--tracer 0|1] [--out <file>] [--dump <file>]
    python3 perfbench/program_spans.py --read <file>

With ``--tracer 1`` the port's tracer is enabled when set-up ends and
drained after the window, and its records reach the readers as
``ctx["program_spans"]``; with ``--tracer 0`` the same traced run keeps it
off, so that the two runs price the tracer (compare the harness's
``ingest.decode_step_ms`` and ``train.optimizer_ms``).  The device trace
also records its window on the epoch clock (``window_ns``), so that the
idle time at its edges is put down to spans too.

The last line of standard output is the result (also appended to
``--out``); ``program_spans`` in it holds the records' count, those
dropped past the buffer's bound, the idle milliseconds by span
(``harness/attribution.py``) and, for a call of the client, the margins
by which its ``vlm.caption_batch`` span holds the call's device intervals:
the first starts after the span starts, the last ends before it ends.
"""
from __future__ import annotations

import argparse
import collections
import gc
import gzip
import json
import os
import statistics
import sys
import threading
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run as bench  # noqa: E402  (starts run.py's clock)
from perfbench.harness.trace import DeviceTrace, SetupClock  # noqa: E402

# the metrics that read the port's spans, and the span that runs the cell
# on the thread whose spans take the idle time, by the mix's kind
SPAN_METRICS = {
    "ingest": ["ingest.decode_host_ms_per_step", "ingest.decode_cpu_share",
               "ingest.call_wait_ms", "ingest.idle_in_decode_step_share"],
    "train": ["train.idle_in_optimizer_share"],
}
TOP = {"ingest": "vlm.caption_batch", "train": "optim.update"}


class EpochTrace(DeviceTrace):
    """``DeviceTrace`` that also gives its window in epoch nanoseconds."""

    def start(self) -> None:
        super().start()
        self._start_ns = time.time_ns()

    def read(self):
        out = super().read()
        out["window_ns"] = (self._start_ns,
                            self._start_ns + int(self.window_s * 1e9))
        return out


class TracerClock(SetupClock):
    """The set-up clock, enabling the port's tracer when set-up ends."""

    def __init__(self, age: float, t0: float, tracer: bool) -> None:
        super().__init__(age, t0)
        self.tracer = tracer

    def stop(self) -> float:
        from vidgraph_tpu_torch.core import profiling

        first = self.seconds is None
        seconds = super().stop()
        if first and self.tracer:
            profiling.enable()
        return seconds


class _Read:
    """A trace already read, for ``run.result_line``."""

    def __init__(self, traced) -> None:
        self._traced = traced

    def read(self):
        return self._traced


def clock_margins(spans, trace, top: str):
    """(µs from the profiled ``top`` span's start to the first device
    interval, µs from the last interval's end to the span's end)."""
    from perfbench.harness import attribution as at

    iv = at.device_intervals(trace)
    held = [sp for sp in at.named(spans, top)
            if at.holds([s for s, _ in iv], sp)]
    if not iv or not held:
        return None
    sp = held[-1]
    inside = [(s, e) for s, e in iv
              if sp["start_ns"] <= s < sp["end_ns"]]
    return {"first_after_start_us": (inside[0][0] - sp["start_ns"]) / 1e3,
            "last_before_end_us": (sp["end_ns"] - max(
                e for _, e in inside)) / 1e3,
            "intervals_outside": len(iv) - len(inside)}


class GcPauses:
    """The interpreter's collections while the tracer is on (``gc``'s
    callbacks): [(start_ns, end_ns, generation, thread)] on the spans'
    clock, so that idle time inside a collection can be told apart."""

    def __init__(self) -> None:
        self.pauses, self._start = [], {}

    def __call__(self, phase, info) -> None:
        now, thread = time.time_ns(), threading.get_ident()
        if phase == "start":
            self._start[thread] = now
        elif thread in self._start:
            self.pauses.append((self._start.pop(thread), now,
                                info["generation"], thread))

    def summary(self, trace) -> dict:
        """The collections inside the trace's window, their ms by
        generation, and the trace's idle ms inside one."""
        from perfbench.harness import attribution as at

        win = at.window(trace)
        inside = sorted((max(s, win[0]), min(e, win[1]), f"gen{gen}")
                        for s, e, gen, _ in self.pauses
                        if e > win[0] and s < win[1])
        ms = collections.defaultdict(float)
        for s, e, gen in inside:
            ms[gen] += (e - s) / 1e6
        idle = at.put_down(at.idle_intervals(at.device_intervals(trace),
                                             win), inside)
        return {"collections": len(inside), "ms": dict(ms),
                "idle_ms": {k: v / 1e6 for k, v in idle.items()
                            if k != at.OUTSIDE}}


def span_costs() -> dict:
    """Nanoseconds a span costs the host, off and on, and a reading of
    each clock the tracer could use (the records made here are dropped)."""
    from vidgraph_tpu_torch.core import profiling

    def per(stmt, n=200_000):
        return min(timeit.repeat(stmt, number=n, repeat=3,
                                 globals={"profiling": profiling,
                                          "time": time})) / n * 1e9

    out = {"time_ns": per("time.time_ns()"),
           "perf_counter_ns_anchored": per("time.perf_counter_ns() + 7"),
           "thread_time_ns": per("time.thread_time_ns()"),
           "span_off": per("with profiling.span('x'):\n    pass")}
    profiling.enable()
    out["span_on"] = per("with profiling.span('x'):\n    pass", 50_000)
    profiling.disable()
    profiling.drain()
    return out


def traced_line(cell, seed: int, seconds: float, tracer: bool,
                clock: SetupClock, device, dump: str = None) -> dict:
    """One traced run of ``cell`` and its result line, with the metrics
    of the port's spans and ``program_spans``; ``dump`` names a file for
    the records inside the trace's window and its device intervals."""
    from perfbench.harness import attribution, manifest
    from vidgraph_tpu_torch.core import profiling

    kind = cell.traffic["kind"]
    harness = cell.harness
    harness.DeviceTrace = EpochTrace
    pauses = GcPauses()
    if tracer:
        gc.callbacks.append(pauses)
    try:
        out = harness.run(cell, seed, seconds, True, clock, device)
    finally:
        harness.DeviceTrace = DeviceTrace
        profiling.disable()
        if pauses in gc.callbacks:
            gc.callbacks.remove(pauses)
    records, dropped = profiling.drain(), profiling.dropped()
    traced = out["trace"].read()
    out["trace"] = _Read(traced)
    line = bench.result_line(cell, out, True, device)
    ctx = {"config": cell.config, "traffic": cell.traffic,
           "peaks": manifest.peaks(), "spans": out["spans"],
           "counters": out["counters"], "trace": traced,
           "program_spans": records}
    for name in SPAN_METRICS[kind]:
        value = manifest.reader(name)(ctx)
        if value is not None:
            line["metrics"][name] = {
                "value": float(value), "unit": "%" if "share" in name
                else "ms"}
    info = {"tracer": int(tracer), "records": len(records),
            "dropped": dropped, "costs_ns": span_costs()}
    thread = attribution.thread_of(records, TOP[kind], traced)
    total = attribution.idle_ns(traced)
    if thread is not None and total > 0:
        idle = attribution.attribute(traced, records, thread, between=True)
        info["idle_ms_by_span"] = {k: v / 1e6 for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])}
        info["idle_ms"] = total / 1e6
        info["idle_in_spans_share"] = 100.0 * (1 - sum(
            v for k, v in idle.items()
            if k.startswith(attribution.OUTSIDE)) / total)
    if kind == "ingest" and records:
        info["clock"] = clock_margins(records, traced, TOP[kind])
    if tracer and attribution.window(traced):
        info["gc"] = pauses.summary(traced)
    line["program_spans"] = info
    line["checks"] = line.pop("checks")
    if dump:
        win = attribution.window(traced)
        with gzip.open(dump, "wt") as f:
            json.dump({"window_ns": win, "kernels": traced["kernels"],
                       "copies": traced["copies"], "records": [
                           r for r in records if r["end_ns"] >= win[0]
                           and r["start_ns"] <= win[1]]}, f)
    return line


GAP_US = (5, 20, 100, 1000, float("inf"))


def read_dump(path: str) -> dict:
    """What a ``--dump`` file shows: the idle time by the length of its
    gaps (ms and count, by the bound in us of each bin), and the median ms
    of each span and of each stretch between two spans on the top span's
    thread."""
    from perfbench.harness import attribution as at

    with gzip.open(path, "rt") as f:
        d = json.load(f)
    trace = {"kernels": d["kernels"], "copies": d["copies"],
             "window_ns": d["window_ns"]}
    gaps = {f"<= {b:g}": [0.0, 0] for b in GAP_US}
    for s, e in at.idle_intervals(at.device_intervals(trace),
                                  d["window_ns"]):
        key = f"<= {next(b for b in GAP_US if e - s <= b * 1e3):g}"
        gaps[key][0] += (e - s) / 1e6
        gaps[key][1] += 1
    records = d["records"]
    top = next(t for t in TOP.values() if at.named(records, t))
    thread = at.thread_of(records, top, trace)
    mine = [r for r in records if r["thread"] == thread]
    spans = collections.defaultdict(list)
    for r in mine:
        spans[r["name"]].append(at.duration(r) / 1e6)
    for a, b, name in at.innermost(mine, between=True):
        if name.startswith(at.OUTSIDE):
            spans[name].append((b - a) / 1e6)
    return {"idle_by_gap_us": gaps,
            "median_ms": {k: statistics.median(v) for k, v in spans.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--dump", default=None,
                    help="write the records and the device intervals of "
                         "the profiled part here (gzipped JSON)")
    ap.add_argument("--read", default=None,
                    help="print what a --dump file shows, and run nothing")
    args = ap.parse_args(argv)
    if args.read:
        print(json.dumps(read_dump(args.read), indent=1))
        return 0
    if None in (args.workload, args.seed, args.seconds):
        ap.error("--workload, --seed and --seconds are required")
    bench._cache_dirs()

    import torch

    clock = TracerClock(bench.AGE0, bench.T0, bool(args.tracer))
    clock.mark("torch")
    if not torch.cuda.is_available():
        return bench._fail("no CUDA card: torch.cuda.is_available() is false")
    from perfbench.harness import manifest

    cell = manifest.cell(args.workload)
    import vidgraph_tpu_torch  # noqa: F401

    clock.mark("port")
    device = torch.device("cuda:0")
    os.environ["VIDGRAPH_TORCH_DEVICE"] = "cuda:0"
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    clock.mark("cuda")
    line = traced_line(cell, args.seed, args.seconds, bool(args.tracer),
                       clock, device, args.dump)
    found = bench.forbidden_modules()
    if found:
        return bench._fail(f"JAX was loaded in the benchmark's process: "
                           f"{found}")
    text = json.dumps(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(json.dumps(line["program_spans"], indent=1), file=sys.stderr)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
