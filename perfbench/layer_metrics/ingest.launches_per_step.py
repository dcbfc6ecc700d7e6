"""Device kernels in the traced call (vision and decode alike) over its
decode steps: a count.  Moves ``caption_chunks_per_s``."""


def read(ctx):
    trace = ctx["trace"]
    steps = ctx["counters"].get("traced_steps", 0)
    if trace is None or steps <= 0 or not trace["kernels"]:
        return None
    return len(trace["kernels"]) / steps
