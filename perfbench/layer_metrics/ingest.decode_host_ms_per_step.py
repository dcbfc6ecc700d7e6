"""Host milliseconds a decode step: the self time of the port's
``captioner.decode_step`` spans (each step's enqueue, without its
``captioner.done_check`` wait) over the steps the loop ran (the
``steps`` counts of ``captioner.decode``), over the window's calls that
the profiler did not record.  Beside ``ingest.decode_step_ms``, which
times ``generate`` from outside, it reads the host's own part of a step.
Moves ``caption_chunks_per_s``."""

from perfbench.harness import attribution as at


def read(ctx):
    spans = ctx.get("program_spans")
    if not spans:
        return None
    kept = at.unprofiled(spans, ctx.get("trace"), "vlm.caption_batch")
    steps = sum(sp["counts"].get("steps", 0)
                for sp in at.named(kept, "captioner.decode"))
    own = (sum(map(at.duration, at.named(kept, "captioner.decode_step")))
           - sum(map(at.duration, at.named(kept, "captioner.done_check"))))
    if steps <= 0 or own <= 0:
        return None
    return own / steps / 1e6
