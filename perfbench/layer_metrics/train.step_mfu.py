"""The whole training step's share of the card's bfloat16 peak: the
model operations of a step (``counts/model_flops.py``: forward and
backward of every matrix, attention over the visible pairs) over the
median step time between the window's CUDA events.  Moves
``train_tokens_per_s``."""

import statistics

from perfbench.counts import model_flops


def read(ctx):
    step_ms = ctx["counters"].get("step_ms", [])
    if not step_ms:
        return None
    mix = ctx["traffic"]
    ops = model_flops.decoder_train(ctx["config"]["captioner"],
                                    mix["batch"], mix["seq_len"])
    return (100.0 * ops / (statistics.median(step_ms) * 1e-3)
            / ctx["peaks"]["bf16_flops_per_s"])
