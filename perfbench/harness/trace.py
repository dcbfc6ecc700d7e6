"""Spans, the device trace and the clock of set-up.

* ``process_age``: seconds since the process started, so that ``setup_s``
  counts the interpreter and the imports too.
* ``Spans``: wraps functions of the port (an attribute of a module or
  class) for the length of a run.  A *timed* span records
  ``torch.profiler.record_function`` and the host clock from its start to
  its end, synchronising the card at its end (and at its start where asked,
  so that it holds no earlier work); while the profiler records, a span
  only names its range.
* ``DeviceTrace``: ``torch.profiler`` with the CUDA activity alone over a
  bounded part of the window (recording every host op as well stretched a
  host-paced step by 40-85 %); ``read`` turns it into the device's
  intervals, the kernels by name, the busy time (the union of the
  intervals) and the idle gaps by the kernel the device waited for.  No
  trace file is written.
"""
from __future__ import annotations

import collections
import contextlib
import os
import re
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class SetupClock:
    """``setup_s``: the process's age when ``stop`` is first called, and
    its age at each ``mark`` on the way (``stages``)."""

    def __init__(self, age: float, t0: float) -> None:
        self._age, self._t0 = age, t0
        self.seconds: Optional[float] = None
        self.stages: List[Tuple[str, float]] = []

    def now(self) -> float:
        return self._age + time.perf_counter() - self._t0

    def mark(self, stage: str) -> None:
        self.stages.append((stage, self.now()))

    def stop(self) -> float:
        if self.seconds is None:
            self.seconds = self.now()
            self.stages.append(("setup", self.seconds))
        return self.seconds


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Spans:
    """Spans around functions of the port, recorded in memory.  While
    ``timing`` is False every span only names its range (the profiled part
    of a window, which a synchronise would change)."""

    def __init__(self) -> None:
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)
        self.timing = True
        self._undo: List[Tuple[object, str, object]] = []

    def wrap(self, owner: object, attr: str, name: str,
             sync_start: bool = False) -> None:
        original = getattr(owner, attr)
        record = self.seconds[name]

        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                if not self.timing:
                    return original(*args, **kwargs)
                if sync_start:
                    _sync()
                t = time.perf_counter()
                out = original(*args, **kwargs)
                _sync()
                record.append(time.perf_counter() - t)
                return out

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, original))

    def restore(self) -> None:
        while self._undo:
            owner, attr, original = self._undo.pop()
            setattr(owner, attr, original)

    @contextlib.contextmanager
    def timed(self, name: str, sync_start: bool = False) -> Iterator[None]:
        """A timed span around a block of the benchmark's own loop."""
        with torch.profiler.record_function(name):
            if not self.timing:
                yield
                return
            if sync_start:
                _sync()
            t = time.perf_counter()
            yield
            _sync()
            self.seconds[name].append(time.perf_counter() - t)


def _ns(event, what: str) -> int:
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")() * 1000)


def _annotation(event) -> bool:
    """A ``record_function`` range, which the trace also draws on the
    device's timeline: no device work."""
    fn = getattr(event, "is_user_annotation", None)
    return bool(fn()) if fn is not None else False


class DeviceTrace:
    """``torch.profiler`` over the blocks run inside ``record()``."""

    COPY = ("Memcpy", "Memset")

    def __init__(self) -> None:
        self._prof = None
        self._t = 0.0
        self.window_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        _sync()
        self._prof = profile(activities=[
            ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU])
        self._prof.start()
        self._t = time.perf_counter()

    def stop(self) -> None:
        _sync()
        self.window_s = time.perf_counter() - self._t
        self._prof.stop()

    @contextlib.contextmanager
    def record(self) -> Iterator[None]:
        self.start()
        try:
            yield
        finally:
            self.stop()

    def read(self) -> Dict:
        """The trace's device intervals and what they add up to:
        ``kernels`` [(name, start_ns, dur_ns)] (copies and memsets apart in
        ``copies``), ``busy_s`` (the union of every device interval),
        ``ops_s`` (device seconds by kernel name) and ``gaps_s`` (idle
        seconds between device intervals, by the kernel or copy that ended
        each gap: what the host was preparing; and the idle time before
        the first interval and after the last)."""
        cuda = torch.autograd.DeviceType.CUDA
        kernels, copies = [], []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda or _annotation(e):
                continue
            item = (e.name(), _ns(e, "start"), _ns(e, "duration"))
            (copies if item[0].startswith(self.COPY) else
             kernels).append(item)
        self._prof = None
        busy, gaps = _union(kernels + copies)
        edges = self.window_s - busy * 1e-9 - sum(gaps.values())
        if edges > 0:
            gaps["before the first device op or after the last"] = edges
        ops: Dict[str, float] = collections.defaultdict(float)
        for name, _, dur in kernels + copies:
            ops[name] += dur * 1e-9
        return {"kernels": kernels, "copies": copies,
                "busy_s": busy * 1e-9, "ops_s": dict(ops), "gaps_s": gaps,
                "window_s": self.window_s}


def _union(items: List[Tuple[str, int, int]]
           ) -> Tuple[int, Dict[str, float]]:
    """(covered ns, idle seconds between intervals by the name of the
    interval that ended each gap)."""
    busy, end = 0, None
    gaps: Dict[str, float] = collections.defaultdict(float)
    for start, stop, name in sorted((s, s + d, n) for n, s, d in items):
        if end is None or start > end:
            if end is not None:
                gaps[f"before {_short(name)}"] += (start - end) * 1e-9
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy, dict(gaps)


def _short(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters."""
    name = re.sub(r"^(void |std::enable_if<.*?>::type )", "", name)
    for cut in ("<", "("):
        i = name.find(cut)
        if i > 0:
            name = name[:i]
    return name.strip()[:120]


def top(named: Dict[str, float], n: int = 10) -> List[List]:
    """The ``n`` largest entries as [[name, seconds], ...]."""
    return [[k, v] for k, v in sorted(named.items(), key=lambda kv: -kv[1])
            [:n]]
