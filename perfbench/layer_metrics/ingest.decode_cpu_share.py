"""Share of the decode steps' host time that the thread spent on a CPU:
the thread CPU nanoseconds of the port's ``captioner.decode_step`` spans
over their wall nanoseconds, each without its ``captioner.done_check``
wait, over the window's calls that the profiler did not record.  Near
100 % the launches' CPU cost paces a step; well under it, the thread was
descheduled.  Moves ``caption_chunks_per_s``."""

from perfbench.harness import attribution as at


def read(ctx):
    spans = ctx.get("program_spans")
    if not spans:
        return None
    kept = at.unprofiled(spans, ctx.get("trace"), "vlm.caption_batch")
    steps = at.named(kept, "captioner.decode_step")
    checks = at.named(kept, "captioner.done_check")
    wall = sum(map(at.duration, steps)) - sum(map(at.duration, checks))
    cpu = (sum(sp["cpu_ns"] for sp in steps)
           - sum(sp["cpu_ns"] for sp in checks))
    if wall <= 0:
        return None
    return 100.0 * cpu / wall
