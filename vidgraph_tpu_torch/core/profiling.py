"""Profiling and timing on the card.

Counterpart of ``vidgraph_tpu/core/profiling.py``.

* The port's tracer: ``span`` marks a stretch of the host's work (a layer
  boundary: ``vlm.caption_batch``, ``captioner.decode_step``,
  ``optim.update`` ...).  While ``enable``-d, each span closes into a
  record of its name, its start and end in Unix-epoch nanoseconds (the
  clock of ``torch.profiler``'s events, so that a device trace lines up
  with the spans), its id, the id of the span open around it in the same
  ``contextvars`` context, the id of the outermost span of its call
  (shared across ``asyncio.to_thread``, which copies the context), its
  thread, the thread's CPU nanoseconds inside it and the counts set on
  it.  Records are kept in memory, at most ``CAPACITY`` of them;
  ``drain`` hands them over, ``dropped`` counts those past the bound.
  A span never synchronises the card: it times the host, and the device
  time comes from a device trace on the same clock.  Disabled (the
  default), a span is one flag test and a shared no-op object: no clock
  reading, no allocation.
* ``device_busy_us`` and ``profile_device`` read the card's busy time and
  launches from ``torch.profiler`` events.
* ``cuda_ms`` times a callable on the card with CUDA events: PyTorch
  returns before the card finishes, so a host clock without a synchronise
  would time the enqueue only.  ``graph_ms`` times the device's work
  alone, replaying the calls from a CUDA graph.
"""
from __future__ import annotations

import contextvars
import itertools
import statistics
import threading
import time
from typing import Callable, Dict, List

import torch

FIELDS = ("name", "start_ns", "end_ns", "span_id", "parent_id", "call_id",
          "thread", "cpu_ns", "counts")
CAPACITY = 200_000

_on = False
_records: List[tuple] = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_current: contextvars.ContextVar = contextvars.ContextVar(
    "vidgraph_span", default=None)
# the clocks a span reads (module attributes, so that a test can count them)
_wall_ns = time.time_ns
_cpu_ns = time.thread_time_ns


def _null_enter() -> "_NullSpan":
    return NULL_SPAN


def _null_exit(exc_type, exc, tb) -> None:
    return None


class _NullSpan:
    """What ``span`` returns while tracing is off: does nothing.  Its
    ``__enter__`` and ``__exit__`` are static, so that a ``with`` binds no
    method object to it (nothing allocated)."""

    __slots__ = ()
    __enter__ = staticmethod(_null_enter)
    __exit__ = staticmethod(_null_exit)

    def set(self, key: str, value) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "counts", "span_id", "parent_id", "call_id",
                 "_token", "_start", "_cpu")

    def __init__(self, name: str, counts: Dict) -> None:
        self.name = name
        self.counts = counts

    def set(self, key: str, value) -> None:
        """Sets a count of the span, kept in its record."""
        self.counts[key] = value

    def __enter__(self) -> "_Span":
        parent = _current.get()
        self.span_id = next(_ids)
        if parent is None:
            self.parent_id, self.call_id = None, self.span_id
        else:
            self.parent_id, self.call_id = parent.span_id, parent.call_id
        self._token = _current.set(self)
        self._cpu = _cpu_ns()
        self._start = _wall_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = _wall_ns()
        cpu = _cpu_ns() - self._cpu
        _current.reset(self._token)
        record = (self.name, self._start, end, self.span_id, self.parent_id,
                  self.call_id, threading.get_ident(), cpu, self.counts)
        global _dropped
        with _lock:
            if len(_records) < CAPACITY:
                _records.append(record)
            else:
                _dropped += 1


def span(name: str, **counts):
    """A span named ``name`` around a ``with`` block, with ``counts``
    (more may be ``set`` on it before it closes)."""
    if not _on:
        return NULL_SPAN
    return _Span(name, counts)


def enable() -> None:
    """Starts recording spans into an empty buffer (of ``CAPACITY``)."""
    global _on, _records, _dropped
    with _lock:
        _records, _dropped = [], 0
    _on = True


def disable() -> None:
    """Stops recording; the records kept stay until ``drain``."""
    global _on
    _on = False


def drain() -> List[Dict]:
    """The records kept since ``enable`` or the last ``drain``, in the
    order their spans closed, as dicts of ``FIELDS``; the buffer empties."""
    global _records
    with _lock:
        out, _records = _records, []
    return [dict(zip(FIELDS, r)) for r in out]


def dropped() -> int:
    """Spans that closed while the buffer was full, since ``enable``."""
    return _dropped


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
