"""The device's idle time put down to the program's own spans.

The port's tracer (``vidgraph_tpu_torch/core/profiling.py``) records its
spans in Unix-epoch nanoseconds, the clock of ``torch.profiler``'s events,
so the idle intervals of a device trace (``trace.DeviceTrace.read``) and
the spans line up without an offset.  Each idle interval inside the
trace's window is put down to the innermost span open at that instant on
one thread: the thread that ran the cell's top span (the client's worker
thread for ``vlm.caption_batch``, the main thread for the trainer's
spans).  What no span of that thread covers goes under ``OUTSIDE``.

A trace gives its window on the epoch clock as ``window_ns`` where the
code that took it recorded one; without it the window is taken from the
first to the last device interval, and the idle time at its edges
(``window_s`` less the busy time and the gaps between) goes under
``OUTSIDE``.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

OUTSIDE = "outside the program's spans"
Interval = Tuple[int, int]


def device_intervals(trace: Dict) -> List[Interval]:
    """[(start_ns, end_ns)] of the trace's kernels, copies and memsets."""
    return sorted((s, s + d) for _, s, d in
                  list(trace["kernels"]) + list(trace.get("copies", [])))


def window(trace: Dict) -> Optional[Interval]:
    """The trace's window on the epoch clock (see the module's text)."""
    if trace.get("window_ns"):
        return tuple(trace["window_ns"])
    iv = device_intervals(trace)
    if not iv:
        return None
    return iv[0][0], max(e for _, e in iv)


def idle_intervals(intervals: Sequence[Interval],
                   win: Interval) -> List[Interval]:
    """The stretches of ``win`` that no interval of ``intervals`` covers."""
    out, t = [], win[0]
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, win[1])))
        t = max(t, e)
        if t >= win[1]:
            break
    if t < win[1]:
        out.append((t, win[1]))
    return [(s, e) for s, e in out if e > s]


def innermost(spans: Iterable[Dict], between: bool = False
              ) -> List[Tuple[int, int, str]]:
    """[(start_ns, end_ns, name)]: the stretches in which some span of
    ``spans`` (one thread's) is open, each with the innermost one, the
    open span that started last.  With ``between``, also the stretches
    between two spans, named by the span that closed before and the one
    that opened after (under ``OUTSIDE``)."""
    events = []
    for i, sp in enumerate(spans):
        events.append((sp["start_ns"], 1, i, sp))
        events.append((sp["end_ns"], 0, i, sp))
    # at one instant spans close before others open
    events.sort(key=lambda ev: (ev[0], ev[1], ev[2]))
    out, stack, t, last = [], [], None, None
    for when, opens, i, sp in events:
        if t is not None and when > t:
            if stack:
                out.append((t, when, stack[-1][1]["name"]))
            elif between:
                out.append((t, when, f"{OUTSIDE}: between {last} and "
                                     f"{sp['name']}"))
        t = when
        if opens:
            stack.append((i, sp))
        else:
            stack = [x for x in stack if x[0] != i]
            last = sp["name"]
    return out


def put_down(idle: Sequence[Interval],
             segments: Sequence[Tuple[int, int, str]]) -> Dict[str, int]:
    """Idle nanoseconds by the name of the segment over them, the rest
    under ``OUTSIDE``."""
    out: Dict[str, int] = collections.defaultdict(int)
    j = 0
    for s, e in idle:
        covered = 0
        while j < len(segments) and segments[j][1] <= s:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < e:
            a, b = max(s, segments[k][0]), min(e, segments[k][1])
            if b > a:
                out[segments[k][2]] += b - a
                covered += b - a
            k += 1
        if e - s > covered:
            out[OUTSIDE] += (e - s) - covered
    return dict(out)


def holds(starts: Sequence[int], sp: Dict) -> bool:
    """Whether a device interval starts inside the span ``sp`` (``starts``
    sorted)."""
    i = bisect.bisect_left(starts, sp["start_ns"])
    return i < len(starts) and starts[i] < sp["end_ns"]


def thread_of(spans: Iterable[Dict], name: str,
              trace: Optional[Dict] = None) -> Optional[int]:
    """The thread of a span named ``name``: of the first one that holds a
    device interval of ``trace`` when a trace is given."""
    starts = [s for s, _ in device_intervals(trace)] if trace else []
    for sp in spans:
        if sp["name"] == name and (not starts or holds(starts, sp)):
            return sp["thread"]
    return None


def attribute(trace: Dict, spans: Sequence[Dict], thread: int,
              between: bool = False) -> Dict[str, int]:
    """The trace's idle nanoseconds by the innermost span of ``thread``
    open over them, and ``OUTSIDE``; they add up to the trace's idle time
    (``window_s`` less ``busy_s``).  ``between`` splits what lies between
    two spans by their names (``innermost``)."""
    win = window(trace)
    if win is None:
        return {}
    segments = innermost((sp for sp in spans if sp["thread"] == thread),
                         between)
    out = put_down(idle_intervals(device_intervals(trace), win), segments)
    if not trace.get("window_ns"):
        edges = (trace["window_s"] - trace["busy_s"]) * 1e9 - sum(
            out.values())
        out[OUTSIDE] = out.get(OUTSIDE, 0) + max(0, round(edges))
    return out


def named(spans: Iterable[Dict], name: str) -> List[Dict]:
    return [sp for sp in spans if sp["name"] == name]


def profiled_calls(spans: Sequence[Dict], trace: Optional[Dict],
                   top: str) -> set:
    """The call ids whose span ``top`` holds a device interval of the
    trace: the calls the profiler recorded."""
    if not trace:
        return set()
    starts = [s for s, _ in device_intervals(trace)]
    return {sp["call_id"] for sp in named(spans, top)
            if holds(starts, sp)}


def unprofiled(spans: Sequence[Dict], trace: Optional[Dict],
               top: str) -> List[Dict]:
    """The spans of the calls the profiler did not record."""
    skip = profiled_calls(spans, trace, top)
    return [sp for sp in spans if sp["call_id"] not in skip]


def duration(sp: Dict) -> int:
    return sp["end_ns"] - sp["start_ns"]


def idle_ns(trace: Dict) -> float:
    return (trace["window_s"] - trace["busy_s"]) * 1e9
