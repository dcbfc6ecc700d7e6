"""Share of the card's memory bandwidth that the decode's needed bytes
take: the bytes its steps need (``counts/decode_step.py``: every weight
once a step, K and V of the attended slots once, in the compute type),
over the span around ``generate``, over the peak bytes a second.  Moves
``caption_chunks_per_s``."""

from perfbench.counts import decode_step


def read(ctx):
    sizes = ctx["config"]["captioner"]
    total = sum(ctx["spans"].get("vlm.generate", []))
    steps = ctx["counters"].get("decode_steps", [])
    if total <= 0 or not steps:
        return None
    prompt = sizes["num_vision_tokens"] + 1
    batch = ctx["counters"]["chunks_per_call"]
    need = sum(decode_step.decode_bytes(sizes, batch, prompt, s)
               for s in steps)
    return 100.0 * need / total / ctx["peaks"]["hbm_bytes_per_s"]
