"""Faults planted in the port underneath a run: the timed path broken, the
rest of the run as it is.  ``perfbench/tests/test_perfbench_faults.py``
sees each come out not ``correct``; ``control.py --faults`` reads a
training cell's compared numbers under them on the card.

* ``unchanged``: the optimizer's update does nothing, so a step returns
  its state unchanged.
* ``half_batch``: the loss is the mean over the first half of the batch's
  rows, the rest left out.
* ``no_weight_decay``: AdamW built with its weight decay at 0.
* ``token_altered``: every fifth call of the captioner's head has its
  logits negated, so a served byte is altered where it is produced.
* ``half_call``: a captioning call captions the first half of its chunks
  and returns their captions twice.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator


def _unchanged(patch) -> None:
    from vidgraph_tpu_torch.models import train

    patch(train.AdamW, "update", lambda self: None)


def _half_batch(patch) -> None:
    from vidgraph_tpu_torch.models import train

    loss = train.masked_cross_entropy

    def half(logits, targets, mask):
        h = len(logits) // 2
        return loss(logits[:h], targets[:h], mask[:h])
    patch(train, "masked_cross_entropy", half)


def _no_weight_decay(patch) -> None:
    from vidgraph_tpu_torch.models import train

    init = train.AdamW.__init__

    def no_decay(self, params, learning_rate, weight_decay=0.01,
                 max_norm=None):
        init(self, params, learning_rate, 0.0, max_norm)
    patch(train.AdamW, "__init__", no_decay)


def _token_altered(patch) -> None:
    from vidgraph_tpu_torch.models import captioner

    head = captioner._head_logits
    calls = []

    def altered(params, cfg, x):
        logits = head(params, cfg, x)
        calls.append(1)
        return -logits if len(calls) % 5 == 3 else logits
    patch(captioner, "_head_logits", altered)


def _half_call(patch) -> None:
    from vidgraph_tpu_torch.services import vlm_client

    whole = vlm_client.TPUVLMClient.caption_batch_sync

    def half(self, chunks):
        texts = whole(self, chunks[:len(chunks) // 2])
        return texts + texts
    patch(vlm_client.TPUVLMClient, "caption_batch_sync", half)


FAULTS: Dict[str, Callable] = {
    "unchanged": _unchanged, "half_batch": _half_batch,
    "no_weight_decay": _no_weight_decay, "token_altered": _token_altered,
    "half_call": _half_call}


@contextlib.contextmanager
def planted(name: str) -> Iterator[None]:
    """The port with fault ``name`` planted, for the block's length."""
    undo = []

    def patch(owner, attr, value):
        undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)
    try:
        FAULTS[name](patch)
        yield
    finally:
        for owner, attr, value in reversed(undo):
            setattr(owner, attr, value)
