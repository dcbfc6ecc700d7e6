"""Milliseconds a call spends between the client's event loop and its
worker thread: the port's ``vlm.caption`` span (on the loop) less its
``vlm.caption_batch`` child (on the worker, reached through
``asyncio.to_thread``), the mean over the window's calls that the
profiler did not record.  Moves ``caption_chunks_per_s``."""

from perfbench.harness import attribution as at


def read(ctx):
    spans = ctx.get("program_spans")
    if not spans:
        return None
    kept = at.unprofiled(spans, ctx.get("trace"), "vlm.caption_batch")
    batch = {sp["parent_id"]: sp
             for sp in at.named(kept, "vlm.caption_batch")}
    waits = [at.duration(sp) - at.duration(batch[sp["span_id"]])
             for sp in at.named(kept, "vlm.caption")
             if sp["span_id"] in batch]
    if not waits:
        return None
    return sum(waits) / len(waits) / 1e6
