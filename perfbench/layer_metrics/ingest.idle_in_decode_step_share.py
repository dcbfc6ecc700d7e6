"""Share of the profiled call's device idle time that falls while the
client's worker thread is inside a ``captioner.decode_step`` span and no
span inside it (the step's enqueue, not its ``captioner.done_check``
wait): the device trace's idle intervals put down to the port's spans on
the clock they share (``harness/attribution.py``), over the trace's
whole idle time.  Moves ``caption_chunks_per_s``."""

from perfbench.harness import attribution as at


def read(ctx):
    spans, trace = ctx.get("program_spans"), ctx.get("trace")
    if not spans or not trace or trace["busy_s"] <= 0 \
            or at.idle_ns(trace) <= 0:
        return None
    thread = at.thread_of(spans, "vlm.caption_batch", trace)
    if thread is None:
        return None
    idle = at.attribute(trace, spans, thread)
    return 100.0 * idle.get("captioner.decode_step", 0) / at.idle_ns(trace)
