"""Milliseconds of device work a decode step: the busy time of the
profiled call (the union of its kernels, copies and memsets, the vision
tower and prefill included) over its decode steps.  Unlike the host-paced
step time, it reads only what the card does.  Moves
``caption_chunks_per_s``."""


def read(ctx):
    trace = ctx["trace"]
    steps = ctx["counters"].get("traced_steps", 0)
    if trace is None or steps <= 0 or trace["busy_s"] <= 0:
        return None
    return 1e3 * trace["busy_s"] / steps
