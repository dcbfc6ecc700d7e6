"""The whole call's share of the card's bfloat16 peak: the model
operations of the tower over every frame, the prefill and every decode
step (``counts/model_flops.py``), over the span around
``caption_batch_sync``, summed over the window's untraced calls.  Moves
``caption_chunks_per_s``."""

from perfbench.counts import model_flops


def read(ctx):
    conf, mix = ctx["config"], ctx["traffic"]
    total = sum(ctx["spans"].get("vlm.caption_batch", []))
    steps = ctx["counters"].get("decode_steps", [])
    if total <= 0 or not steps:
        return None
    cap = conf["captioner"]
    b = ctx["counters"]["chunks_per_call"]
    prompt = cap["num_vision_tokens"] + 1
    per_call = (model_flops.vit_forward(conf["vit"],
                                        b * mix["frames_per_chunk"])
                + model_flops.decoder_forward(cap, b, 1, 1))
    ops = sum(per_call + sum(model_flops.decode_step(cap, b, prompt + i + 1)
                             for i in range(s)) for s in steps)
    return 100.0 * ops / total / ctx["peaks"]["bf16_flops_per_s"]
