"""The attention kernels' share of the device time of every kernel in
the traced steps (the kernels whose names say attention, as
``train.attn_roofline`` finds them).  Moves ``train_tokens_per_s``."""

import re

ATTENTION = re.compile(r"attn|attention|flash", re.IGNORECASE)


def read(ctx):
    trace = ctx["trace"]
    if trace is None or not trace["kernels"]:
        return None
    total = sum(d for _, _, d in trace["kernels"])
    attn = sum(d for name, _, d in trace["kernels"] if ATTENTION.search(name))
    if attn <= 0:
        return None
    return 100.0 * attn / total
