"""Profiling and timing on the card.

Counterpart of ``vidgraph_tpu/core/profiling.py``: ``device_trace`` records
a ``torch.profiler`` trace (CPU and CUDA activities) where the JAX package
records a ``jax.profiler`` one, and ``span`` is the same wall-clock span,
optionally annotated into the trace.  ``cuda_ms`` times a callable on the
card with CUDA events: PyTorch returns before the card finishes, so a host
clock without a synchronise would time the enqueue only.  ``graph_ms``
times the device's work alone, replaying the calls from a CUDA graph.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import torch

from .logger import get_logger
from .metrics import MetricsTracker

logger = get_logger("profiling")


@contextlib.contextmanager
def device_trace(log_dir: str = "profiles") -> Iterator[object]:
    """Record a torch.profiler trace of the enclosed block; yields the
    profiler (``key_averages()`` for tables) and writes a Chrome trace
    under ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    out = Path(log_dir) / f"trace_{int(time.time() * 1e3)}.json"
    prof.export_chrome_trace(str(out))
    logger.info("Device trace written to %s (open with chrome://tracing "
                "or Perfetto)", out)


@contextlib.contextmanager
def span(name: str, metrics: Optional[MetricsTracker] = None,
         annotate_device: bool = False) -> Iterator[None]:
    """Wall-clock span; optionally also a ``record_function`` range so the
    region shows up inside device traces."""
    ctx = contextlib.nullcontext()
    if annotate_device:
        ctx = torch.profiler.record_function(name)
    t0 = time.perf_counter()
    with ctx:
        yield
    dt = time.perf_counter() - t0
    if metrics is not None:
        metrics.record_timing(name, dt)
    logger.debug("span %s: %.3fs", name, dt)


def device_busy_us(events) -> float:
    """Length of the union of the time ranges of profiler ``events`` (the
    device's kernels, copies and memsets), in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def profile_device(fn: Callable[[], object]) -> Dict[str, float]:
    """One ``fn()`` under ``torch.profiler`` (CPU and CUDA activities),
    synchronised: the device's busy milliseconds (``device_busy_us``),
    the kernel launches the host made (runtime and driver API, cluster
    launches included) and the device kernels that ran."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"device_busy_ms": device_busy_us(dev) / 1e3,
            "launches": sum(1 for e in events if e.name.startswith(
                ("cudaLaunchKernel", "cuLaunchKernel"))),
            "device_kernels": sum(1 for e in dev if not e.name.startswith(
                ("Memcpy", "Memset")))}


def cuda_ms(fn: Callable[[], object], reps: int = 20,
            warmup: int = 3) -> float:
    """Median milliseconds of ``fn()`` on the current CUDA stream, each run
    between two CUDA events, after ``warmup`` untimed runs."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_ms times on a CUDA card; none is available")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn: Callable[[], object], reps: int = 20,
             replays: int = 5) -> float:
    """Device milliseconds per ``fn()``: ``reps`` calls captured into one
    CUDA graph, each replay timed with CUDA events, the median of
    ``replays`` over ``reps``.  Unlike ``cuda_ms`` of one call it leaves out
    the host's time to launch the work, which exceeds a small kernel's.
    ``fn`` must be capturable: no host synchronisation, no pageable
    copies (tables it keeps are made by the warm-up calls)."""
    if not torch.cuda.is_available():
        raise RuntimeError("graph_ms times on a CUDA card; none is "
                           "available")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)
