"""Milliseconds a step in the optimizer: the span around ``AdamW.update``
(the clip by global norm and the AdamW update), synchronised at its start
and its end, averaged over the traced steps.  Moves
``train_tokens_per_s``."""


def read(ctx):
    spans = ctx["spans"].get("train.optimizer", [])
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
