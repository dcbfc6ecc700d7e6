"""Share of the traced call in which no kernel, copy or memset ran on the
card: 1 - (the union of the device's intervals) / (the traced window).
Moves ``caption_chunks_per_s``."""


def read(ctx):
    trace = ctx["trace"]
    if trace is None or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
