"""Share of the traced steps' device idle time that falls while the main
thread is inside the port's ``optim.update`` span (``AdamW.update``: the
clip, ``optim.clip``, and the update, ``optim.adamw``, included): the
device trace's idle intervals put down to the port's spans on the clock
they share (``harness/attribution.py``), over the trace's whole idle
time.  Moves ``train_tokens_per_s``."""

from perfbench.harness import attribution as at

OPTIMIZER = ("optim.update", "optim.clip", "optim.adamw")


def read(ctx):
    spans, trace = ctx.get("program_spans"), ctx.get("trace")
    if not spans or not trace or trace["busy_s"] <= 0 \
            or at.idle_ns(trace) <= 0:
        return None
    thread = at.thread_of(spans, "optim.update", trace)
    if thread is None:
        return None
    idle = at.attribute(trace, spans, thread)
    return 100.0 * sum(idle.get(n, 0) for n in OPTIMIZER) / at.idle_ns(trace)
