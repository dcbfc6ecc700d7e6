"""The attention kernels' share of their roofline in the traced steps:
the least time the card could take for the forward and the backward of
every layer's attention (the larger of operations over the bfloat16 peak
and bytes over the memory bandwidth, ``counts/attention_{fwd,bwd}.py``)
over the device time of the kernels whose names say attention (``attn``,
``attention`` or ``flash``).  Moves ``train_tokens_per_s``."""

import re

from perfbench.counts import attention_bwd, attention_fwd

ATTENTION = re.compile(r"attn|attention|flash", re.IGNORECASE)
ELEM = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(ctx):
    trace, sizes = ctx["trace"], ctx["config"]["captioner"]
    steps = ctx["counters"].get("traced_steps", 0)
    if trace is None or steps <= 0:
        return None
    seconds = sum(d for name, _, d in trace["kernels"]
                  if ATTENTION.search(name)) * 1e-9
    if seconds <= 0:
        return None
    mix, peaks = ctx["traffic"], ctx["peaks"]
    b, nv = mix["batch"], sizes["num_vision_tokens"]
    t, h = nv + mix["seq_len"], sizes["heads"]
    hd, elem = sizes["width"] // h, ELEM[sizes["dtype"]]
    least = 0.0
    for count, moved in (
            (attention_fwd.ops(b, h, t, hd, nv),
             attention_fwd.bytes_moved(b, h, t, hd, elem)),
            (attention_bwd.ops(b, h, t, hd, nv),
             attention_bwd.bytes_moved(b, h, t, hd, elem))):
        least += max(count / peaks["bf16_flops_per_s"],
                     moved / peaks["hbm_bytes_per_s"])
    return 100.0 * least * sizes["layers"] * steps / seconds
