"""The port's tracer (``vidgraph_tpu_torch/core/profiling.py``) and its
spans at the layer boundaries, on the CPU.

Off, a span is a shared no-op object: no record, no clock reading, no
allocation.  On, spans nest by ``contextvars`` (one ``call_id`` a client
call, across ``asyncio.to_thread``), the buffer keeps at most its bound and
counts the rest, and a span's epoch nanoseconds bracket a
``torch.profiler`` event recorded inside it.  The decoder's and the
optimizer's outputs are bit-identical with the tracer on and off, and the
decode's ``steps`` count is ``decode_steps`` of its tokens.
"""
import asyncio
import os
import sys
import threading
import tracemalloc

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu_torch.core import profiling  # noqa: E402
from vidgraph_tpu_torch.models import captioner as cap  # noqa: E402
from vidgraph_tpu_torch.models.tokenizer import EOS_ID  # noqa: E402
from vidgraph_tpu_torch.models.train import AdamW  # noqa: E402
from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient  # noqa: E402


@pytest.fixture
def tracer():
    """The tracer on for one test, and off with an empty buffer after."""
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.drain()


@pytest.fixture
def off():
    profiling.disable()
    profiling.drain()
    return profiling


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def test_off_records_nothing_and_returns_the_shared_no_op(off):
    with profiling.span("a", n=1) as a:
        a.set("m", 2)
        with profiling.span("b") as b:
            pass
    assert a is b is profiling.NULL_SPAN
    assert profiling.drain() == [] and profiling.dropped() == 0


def test_off_reads_no_clock_and_allocates_nothing(off, monkeypatch):
    reads = []
    monkeypatch.setattr(profiling, "_wall_ns", lambda: reads.append(1))
    monkeypatch.setattr(profiling, "_cpu_ns", lambda: reads.append(1))
    span = profiling.span

    def spans(n):
        for _ in range(n):
            with span("captioner.decode_step") as sp:
                sp.set("steps", 1)

    def loop(n):
        for _ in range(n):
            pass

    def traced(fn, n):
        fn(100)                         # warm every free list first
        tracemalloc.start()
        try:
            fn(n)
            return tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()

    # the loop's own frame and iterator are all a run of 10,000 spans takes
    assert traced(spans, 10_000) == traced(loop, 10_000)
    assert traced(spans, 10_000)[0] == 0
    assert reads == []


def test_on_spans_nest_with_ids_counts_and_clocks(tracer):
    with profiling.span("outer", batch=3) as outer:
        with profiling.span("inner") as inner:
            inner.set("steps", 7)
            sum(range(20_000))
        with profiling.span("inner"):
            pass
    with profiling.span("next"):
        pass
    recs = profiling.drain()
    by = _by_name(recs)
    assert [r["name"] for r in recs] == ["inner", "inner", "outer", "next"]
    o, n = by["outer"][0], by["next"][0]
    assert o["parent_id"] is None and o["call_id"] == o["span_id"]
    for r in by["inner"]:
        assert r["parent_id"] == o["span_id"] and r["call_id"] == o["call_id"]
        assert o["start_ns"] <= r["start_ns"] <= r["end_ns"] <= o["end_ns"]
    assert n["parent_id"] is None and n["call_id"] != o["call_id"]
    assert o["counts"] == {"batch": 3}
    assert by["inner"][0]["counts"] == {"steps": 7}
    assert {r["thread"] for r in recs} == {threading.get_ident()}
    assert all(r["cpu_ns"] >= 0 for r in recs)
    assert set(recs[0]) == set(profiling.FIELDS)
    assert outer is not profiling.NULL_SPAN
    assert profiling.drain() == []


@pytest.mark.parametrize("capacity,spans", [(3, 5), (5, 5), (0, 2),
                                            (1000, 10)])
def test_buffer_keeps_its_bound_and_counts_the_dropped(capacity, spans,
                                                       monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", capacity)
    profiling.enable()
    try:
        for i in range(spans):
            with profiling.span(f"s{i}"):
                pass
        recs = profiling.drain()
        assert [r["name"] for r in recs] == [f"s{i}" for i in
                                             range(min(capacity, spans))]
        assert profiling.dropped() == max(0, spans - capacity)
    finally:
        profiling.disable()
        profiling.drain()


def test_threads_lose_no_record_and_no_drop(monkeypatch):
    """Spans closing on many threads at once: every one is either kept
    or counted as dropped, and the buffer holds no more than its bound."""
    monkeypatch.setattr(profiling, "CAPACITY", 3_000)
    workers, each = 16, 400
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    profiling.enable()
    try:
        def work():
            for _ in range(each):
                with profiling.span("outer"):
                    with profiling.span("inner"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        recs = profiling.drain()
        assert len(recs) == 3_000
        assert len(recs) + profiling.dropped() == 2 * workers * each
        ids = {r["span_id"] for r in recs}
        assert len(ids) == len(recs)
        for r in recs:
            assert r["parent_id"] is None or r["name"] == "inner"
    finally:
        sys.setswitchinterval(switch)
        profiling.disable()
        profiling.drain()


def test_span_clock_brackets_a_profiler_event(tracer):
    """The spans' clock is the device trace's: a ``record_function`` event
    recorded inside a span by ``torch.profiler`` lies inside it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with torch.profiler.record_function("vidgraph_clock_probe"):
                torch.ones(64).sum()
    (rec,) = profiling.drain()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "vidgraph_clock_probe"]
    assert events
    for e in events:
        start = int(e.start_ns())
        end = start + int(e.duration_ns())
        assert rec["start_ns"] <= start <= end <= rec["end_ns"], (
            rec["start_ns"], start, end, rec["end_ns"])


def test_one_call_id_across_the_clients_thread_hop(tracer):
    """``TPUVLMClient.caption`` opens ``vlm.caption`` on the event loop and
    ``caption_batch_sync`` runs on a worker thread (``asyncio.to_thread``
    copies the context): every span of the call shares its ``call_id``."""
    client = TPUVLMClient(preset="tiny64", max_new=20)
    frames = list(np.random.default_rng(5).integers(
        0, 256, (3, 48, 64, 3), dtype=np.uint8))
    profiling.drain()
    text = asyncio.run(client.caption(frames))
    assert isinstance(text, str)
    recs = profiling.drain()
    by = _by_name(recs)
    (call,) = by["vlm.caption"]
    (batch,) = by["vlm.caption_batch"]
    assert {r["call_id"] for r in recs} == {call["span_id"]}
    assert batch["parent_id"] == call["span_id"]
    assert batch["thread"] != call["thread"]
    assert batch["counts"] == {"chunks": 1, "frames": 3}
    for name in ("vlm.host_frames", "vlm.embed_frames",
                 "vlm.vision_prefixes", "vlm.tokens_to_host",
                 "captioner.generate"):
        (r,) = by[name]
        assert r["parent_id"] == batch["span_id"], name
        assert r["thread"] == batch["thread"]
    (gen,) = by["captioner.generate"]
    assert gen["counts"] == {"batch": 1}
    ids = {r["span_id"]: r for r in recs}
    for r in by["captioner.decode_step"]:
        assert ids[r["parent_id"]]["name"] == "captioner.decode"


# ---------------------------------------------------------------------------
# the decoder's and the optimizer's spans
# ---------------------------------------------------------------------------

def _tiny(eos: bool):
    cfg = cap.CaptionerConfig.tiny()
    params = cap.init_params(cfg, seed=3)
    if eos:
        # every position's logits put EOS first: the rows are done at once
        params["ln_f_scale"] = torch.zeros_like(params["ln_f_scale"])
        params["ln_f_bias"] = torch.ones_like(params["ln_f_bias"])
        params["head_w"] = torch.zeros_like(params["head_w"])
        params["head_w"][:, EOS_ID] = 1.0
    return cfg, params


def _tiny64():
    client = TPUVLMClient(preset="tiny64", max_new=8)
    return client.cap_cfg, client._serve_params


def _decode_inputs(cfg, kind):
    g = torch.Generator().manual_seed(11)
    if kind == "generate":
        return (torch.randn(2, cfg.num_vision_tokens, cfg.vision_dim,
                            generator=g),)
    tokens = torch.randint(0, 256, (2, 6), generator=g, dtype=torch.int32)
    return tokens, torch.tensor([6, 3], dtype=torch.int32)


def _decode(kind, cfg, params, inputs, max_new):
    if kind == "generate":
        return cap.generate(params, cfg, *inputs, max_new=max_new)
    return cap.generate_from_tokens(params, cfg, *inputs, max_new=max_new)


@pytest.mark.parametrize("kind", ["generate", "generate_from_tokens"])
@pytest.mark.parametrize("preset,max_new", [
    ("tiny", 10), ("tiny", 40), ("tiny_eos", 10), ("tiny_eos", 40),
    ("tiny64", 33)])
def test_decode_counts_its_steps_and_leaves_tokens_unchanged(
        kind, preset, max_new):
    cfg, params = _tiny64() if preset == "tiny64" else _tiny(
        preset == "tiny_eos")
    inputs = _decode_inputs(cfg, kind)
    profiling.disable()
    plain = _decode(kind, cfg, params, inputs, max_new)
    profiling.enable()
    try:
        traced = _decode(kind, cfg, params, inputs, max_new)
        by = _by_name(profiling.drain())
    finally:
        profiling.disable()
    assert torch.equal(plain, traced)
    steps = cap.decode_steps(traced, max_new)
    (decode,) = by["captioner.decode"]
    (gen,) = by["captioner.generate"]
    (prefill,) = by["captioner.prefill"]
    assert decode["counts"]["steps"] == steps
    checks = len(by.get("captioner.done_check", []))
    assert decode["counts"]["done_checks"] == checks == sum(
        1 for i in range(steps + 1)
        if i % cap._DONE_CHECK == cap._DONE_CHECK - 1 and i != max_new - 1)
    # one span a step, and one for the iteration that leaves the loop
    assert len(by["captioner.decode_step"]) == steps + 1
    assert gen["counts"] == {"batch": 2}
    assert decode["parent_id"] == prefill["parent_id"] == gen["span_id"]
    if preset == "tiny_eos" and max_new > cap._DONE_CHECK:
        assert steps == cap._DONE_CHECK - 1


def test_optimizer_update_is_bit_identical_and_spanned():
    cfg = cap.CaptionerConfig.tiny()
    g = torch.Generator().manual_seed(4)
    vis = torch.randn(2, cfg.num_vision_tokens, cfg.vision_dim, generator=g)
    toks = torch.randint(0, 256, (2, 12), generator=g)

    def steps(trace):
        params = cap.init_params(cfg, seed=5, requires_grad=True)
        opt = AdamW(params, 1e-3, weight_decay=0.01, max_norm=1.0)
        (profiling.enable if trace else profiling.disable)()
        try:
            for _ in range(2):
                opt.zero_grad()
                logits = cap.forward(params, cfg, vis, toks[:, :-1])
                torch.nn.functional.cross_entropy(
                    logits.reshape(-1, logits.shape[-1]),
                    toks[:, 1:].reshape(-1)).backward()
                opt.update()
            return [p.detach().clone() for p in opt.leaves], \
                profiling.drain()
        finally:
            profiling.disable()

    plain, none = steps(False)
    traced, recs = steps(True)
    assert none == []
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    by = _by_name(recs)
    assert len(by["captioner.forward"]) == len(by["optim.update"]) == 2
    for u in by["optim.update"]:
        assert u["counts"] == {"leaves": len(plain)}
    ids = {r["span_id"]: r for r in recs}
    for name in ("optim.clip", "optim.adamw"):
        assert len(by[name]) == 2
        assert all(ids[r["parent_id"]]["name"] == "optim.update"
                   for r in by[name])
