"""``harness/attribution.py`` and the readers of the port's spans on
synthetic device intervals and spans: nested spans on two threads, idle
time at the window's edges and between spans, and the readers' ``None``
where their records are missing."""
import pytest

from perfbench.harness import attribution as at
from perfbench.harness import manifest

MS = 1_000_000
MAIN, WORKER = 1, 2
SPAN_METRICS = ["ingest.decode_host_ms_per_step", "ingest.decode_cpu_share",
                "ingest.call_wait_ms", "ingest.idle_in_decode_step_share",
                "train.idle_in_optimizer_share"]


class Spans:
    """Records as the port's tracer drains them, built by hand."""

    def __init__(self):
        self.records, self.next = [], 1

    def add(self, name, start, end, thread, parent=None, cpu=None, **counts):
        sid = self.next
        self.next += 1
        call = parent["call_id"] if parent else sid
        rec = {"name": name, "start_ns": start, "end_ns": end,
               "span_id": sid, "parent_id": parent["span_id"] if parent
               else None, "call_id": call, "thread": thread,
               "cpu_ns": end - start if cpu is None else cpu,
               "counts": counts}
        self.records.append(rec)
        return rec


def _trace(kernels, window=None):
    """A read trace of device intervals [(start, end)] (ns)."""
    iv = [("k", s, e - s) for s, e in kernels]
    busy, end = 0, None
    for s, e in sorted(kernels):
        if end is None or s >= end:
            busy, end = busy + e - s, e
        elif e > end:
            busy, end = busy + e - end, e
    win = window or (kernels[0][0], max(e for _, e in kernels))
    trace = {"kernels": iv, "copies": [], "busy_s": busy * 1e-9,
             "window_s": (win[1] - win[0]) * 1e-9}
    if window:
        trace["window_ns"] = window
    return trace


def _call(sp, t0, steps_ms, check_ms=0, cpu_share=1.0, kernels=()):
    """One client call from ``t0`` (ms): ``vlm.caption`` on the main
    thread, ``vlm.caption_batch`` 1 ms later on the worker, a decode of
    one step a length of ``steps_ms``, a done check of ``check_ms`` in the
    last step, and the call's device intervals (ms, relative to t0)."""
    t = t0 * MS
    total = (sum(steps_ms) + 4) * MS
    call = sp.add("vlm.caption", t, t + total + 2 * MS, MAIN)
    batch = sp.add("vlm.caption_batch", t + MS, t + total + MS, WORKER, call,
                   chunks=1, frames=5)
    sp.add("vlm.host_frames", t + MS, t + 2 * MS, WORKER, batch)
    gen = sp.add("captioner.generate", t + 2 * MS, t + total, WORKER, batch,
                 batch=1)
    sp.add("captioner.prefill", t + 2 * MS, t + 3 * MS, WORKER, gen)
    s = t + 3 * MS
    dec = sp.add("captioner.decode", s, s + sum(steps_ms) * MS, WORKER, gen,
                 steps=len(steps_ms) - 1, done_checks=1 if check_ms else 0)
    for i, ms in enumerate(steps_ms):
        step = sp.add("captioner.decode_step", s, s + ms * MS, WORKER, dec,
                      cpu=int(ms * MS * cpu_share))
        if check_ms and i == len(steps_ms) - 1:
            sp.add("captioner.done_check", s, s + check_ms * MS, WORKER,
                   step, cpu=0)
        s += ms * MS
    return [(t + a * MS, t + b * MS) for a, b in kernels]


def test_idle_put_down_to_the_innermost_span_of_one_thread():
    sp = Spans()
    # the worker thread: a call span with two nested children
    top = sp.add("top", 10, 100, WORKER)
    mid = sp.add("mid", 20, 80, WORKER, top)
    sp.add("leaf", 30, 40, WORKER, mid)
    sp.add("leaf", 60, 70, WORKER, mid)
    # the main thread holds a span over everything: not this thread's
    sp.add("main", 0, 200, MAIN)
    trace = _trace([(35, 38), (50, 55), (90, 95)], window=(0, 120))
    idle = at.attribute(trace, sp.records, WORKER)
    assert idle == {
        at.OUTSIDE: 10 + 20,             # [0, 10), [100, 120)
        "top": 10 + 10 + 5,              # [10, 20), [80, 90), [95, 100)
        "mid": 10 + 10 + 5 + 10,         # [20, 30), [40, 50), [55, 60),
                                         # [70, 80)
        "leaf": 5 + 2 + 10,              # [30, 35), [38, 40), [60, 70)
    }
    assert sum(idle.values()) == pytest.approx(at.idle_ns(trace))
    assert at.attribute(trace, sp.records, MAIN) == {
        "main": 120 - 3 - 5 - 5}


def test_edges_go_outside_without_an_epoch_window():
    sp = Spans()
    sp.add("step", 10, 50, MAIN)
    trace = _trace([(20, 30), (40, 45)])
    trace["window_s"] += 15e-9           # idle before the first interval
    idle = at.attribute(trace, sp.records, MAIN)
    assert idle == {"step": 10, at.OUTSIDE: 15}
    assert sum(idle.values()) == pytest.approx(at.idle_ns(trace))


def test_between_names_the_spans_on_either_side():
    sp = Spans()
    sp.add("forward", 0, 10, MAIN)
    sp.add("update", 30, 40, MAIN)
    sp.add("forward", 50, 60, MAIN)
    trace = _trace([(5, 6), (55, 56)], window=(0, 70))
    idle = at.attribute(trace, sp.records, MAIN, between=True)
    assert idle[f"{at.OUTSIDE}: between forward and update"] == 20
    assert idle[f"{at.OUTSIDE}: between update and forward"] == 10
    assert idle[at.OUTSIDE] == 10        # after the last span
    assert sum(idle.values()) == pytest.approx(at.idle_ns(trace))


def test_interleaved_spans_take_the_latest_started():
    sp = Spans()
    sp.add("a", 0, 20, MAIN)
    sp.add("b", 10, 30, MAIN)
    assert at.innermost(sp.records) == [(0, 10, "a"), (10, 20, "b"),
                                        (20, 30, "b")]


def test_thread_and_calls_of_the_profiled_span():
    sp = Spans()
    _call(sp, 0, [10, 10])
    kernels = _call(sp, 100, [10, 10], kernels=[(4, 5)])
    trace = _trace(kernels)
    assert at.thread_of(sp.records, "vlm.caption_batch", trace) == WORKER
    second = [r for r in sp.records if r["name"] == "vlm.caption"][1]
    assert at.profiled_calls(sp.records, trace, "vlm.caption_batch") == {
        second["call_id"]}
    assert at.profiled_calls(sp.records, None, "vlm.caption_batch") == set()


def _ingest_ctx():
    sp = Spans()
    _call(sp, 0, [10, 20, 30], check_ms=5, cpu_share=0.5)
    _call(sp, 100, [20, 20], cpu_share=0.5)
    # the profiled call: a kernel in its prefill and one in its 2nd step,
    # from 1 ms after the call's top span starts to 1 ms before it ends
    kernels = _call(sp, 200, [40, 40],
                    kernels=[(2, 3), (48, 50), (84, 85)])
    trace = _trace(kernels, window=(200 * MS, 290 * MS))
    return {"program_spans": sp.records, "trace": trace}


def _train_ctx():
    sp = Spans()
    for t in (0, 100):
        sp.add("captioner.forward", t * MS, (t + 30) * MS, MAIN)
        upd = sp.add("optim.update", (t + 60) * MS, (t + 90) * MS, MAIN,
                     leaves=4)
        sp.add("optim.clip", (t + 60) * MS, (t + 80) * MS, MAIN, upd)
        sp.add("optim.adamw", (t + 80) * MS, (t + 88) * MS, MAIN, upd)
    # a backward on another thread, busy from 30 to 55 ms of each step
    sp.add("autograd", 30 * MS, 60 * MS, 7)
    kernels = [(0, 25 * MS), (30 * MS, 55 * MS), (70 * MS, 71 * MS),
               (100 * MS, 125 * MS), (130 * MS, 155 * MS),
               (170 * MS, 171 * MS)]
    return {"program_spans": sp.records,
            "trace": _trace(kernels, window=(0, 200 * MS))}


def test_ingest_readers_on_a_synthetic_window():
    ctx = _ingest_ctx()
    read = {m: manifest.reader(m)(ctx) for m in SPAN_METRICS[:4]}
    # the two unprofiled calls: 60 + 40 ms of steps, 5 ms of it a done
    # check, over 2 + 1 steps
    assert read["ingest.decode_host_ms_per_step"] == pytest.approx(95 / 3)
    # half the steps' wall time on a CPU; the check's (0 CPU) left out
    assert read["ingest.decode_cpu_share"] == pytest.approx(
        100 * 0.5 * 100 / 95)
    # vlm.caption 2 ms longer than vlm.caption_batch in every call
    assert read["ingest.call_wait_ms"] == pytest.approx(2.0)
    # the profiled call's 90 ms window, 4 ms busy: idle 86 ms, of which
    # 40 + 5 ms in its first step (to the kernel at 48 ms) and 33 ms in
    # its second (from 50 to 83 ms)
    assert read["ingest.idle_in_decode_step_share"] == pytest.approx(
        100 * 78 / 86)


def test_train_reader_on_a_synthetic_window():
    ctx = _train_ctx()
    # idle 200 - 102 = 98 ms; in optim.*: [60, 70) + [71, 90) a step
    share = manifest.reader("train.idle_in_optimizer_share")(ctx)
    assert share == pytest.approx(100 * 2 * (10 + 19) / 98)


@pytest.mark.parametrize("metric,missing", [
    (m, how) for m in SPAN_METRICS for how in ("no key", "empty")] + [
    # the idle shares read the device trace as well
    (m, "no trace") for m in SPAN_METRICS if "idle" in m])
def test_readers_return_none_without_their_records(metric, missing):
    ctx = _train_ctx() if metric.startswith("train") else _ingest_ctx()
    if missing == "no key":
        del ctx["program_spans"]
    elif missing == "empty":
        ctx["program_spans"] = []
    else:
        ctx["trace"] = None
    assert manifest.reader(metric)(ctx) is None


def test_readers_return_none_on_a_parents_ctx():
    """A run of a program without the tracer: ``run.py``'s ctx has no
    ``program_spans`` key at all."""
    ctx = _ingest_ctx()
    parent = {k: v for k, v in ctx.items() if k != "program_spans"}
    for metric in SPAN_METRICS:
        assert manifest.reader(metric)(parent) is None
