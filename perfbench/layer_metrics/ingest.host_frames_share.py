"""Share of a call's time in which the client stacks the chunks' frames
on the host: the span around ``TPUVLMClient.host_frames`` over the span
around ``caption_batch_sync``, summed over the window's untraced calls.
Moves ``caption_chunks_per_s``."""


def read(ctx):
    spans = ctx["spans"]
    total = sum(spans.get("vlm.caption_batch", []))
    stacking = sum(spans.get("vlm.host_frames", []))
    if total <= 0 or stacking <= 0:
        return None
    return 100.0 * stacking / total
