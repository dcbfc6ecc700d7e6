"""Milliseconds a decode step: the span around ``captioner.generate``
(the prefill and the decode loop) over the steps the loop ran
(``decode_steps``), summed over the window's untraced calls.  Moves
``caption_chunks_per_s``."""


def read(ctx):
    total = sum(ctx["spans"].get("vlm.generate", []))
    steps = sum(ctx["counters"].get("decode_steps", []))
    if total <= 0 or steps <= 0:
        return None
    return 1e3 * total / steps
