"""``scripts/measure_torch_stream_scaling.py`` on the CPU at a small size.

Its ``run`` drives the port's ``simulate`` over numpy frame sources with
the deterministic ``LocalVLMClient`` and the hash embed client.  A query's
latency under load runs from its arrival to its answer: it is never below
the engine's own service time of the same query, and a caption batch that
holds the event loop while a query arrives shows in it in full.
"""
import importlib.util
import os
import time
from pathlib import Path

os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"

import pytest  # noqa: E402

from vidgraph_tpu_torch.services.embed_client import make_embed_client  # noqa: E402,E501
from vidgraph_tpu_torch.services.vlm_client import LocalVLMClient  # noqa: E402,E501

SCRIPT = (Path(__file__).resolve().parent.parent / "scripts"
          / "measure_torch_stream_scaling.py")
STALL_S = 0.4


def _script():
    spec = importlib.util.spec_from_file_location("stream_scaling", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class StallingVLM(LocalVLMClient):
    """A caption batch that holds the event loop for ``stall`` seconds,
    as a batch on the device does."""

    def __init__(self, stall: float = STALL_S):
        super().__init__()
        self.stall = stall

    async def caption_batch(self, chunks, *args, **kwargs):
        time.sleep(self.stall)
        return await super().caption_batch(chunks, *args, **kwargs)


@pytest.mark.parametrize("realtime", [False, True])
def test_every_query_waits_at_least_its_service_time(realtime):
    mod = _script()
    seconds = 2.5
    engine, out = mod.run(2, LocalVLMClient(), make_embed_client("hash"),
                          seconds, realtime=realtime)
    asked = mod.queries(2, seconds)
    assert len(engine.submitted) == len(asked) == out["queries_served"]
    assert all(fut.done() for _, fut in engine.submitted)
    services = [fut.result()["latency_ms"] for _, fut in engine.submitted]
    # a query arrives no later than it is submitted, and its answer's clock
    # stops after the engine's own: each wait covers its service time
    assert len(out["query_waits_ms"]) == len(services)
    assert all(w >= s for w, s in zip(out["query_waits_ms"], services))
    assert out["query_under_load_p50_ms"] >= out["query_p50_ms"]
    assert out["query_under_load_p95_ms"] >= out["query_p95_ms"]
    assert out["chunks_done"] > 0 and out["coverage"] is not None


def test_a_stalled_batch_shows_in_the_wait_not_the_service_time():
    mod = _script()
    seconds = 2.0
    engine, out = mod.run(2, StallingVLM(), make_embed_client("hash"),
                          seconds, realtime=True)
    # queries arrive at 1.1 video-seconds, while the first window's batch
    # (started near 0.97 s) holds the loop until about 1.37 s
    assert out["batches"] >= 1
    assert out["query_under_load_p95_ms"] >= 0.5 * STALL_S * 1e3
    assert out["query_p95_ms"] < out["query_under_load_p95_ms"]


def test_a_paced_run_takes_up_every_arrived_query_before_its_next_batch():
    """Batches of 1.2 s on 1 s windows: the paced run ends behind the wall
    clock and its loop jumps over its last query (2.6 video-seconds, 2.7 s
    of video), which arrives during the second batch.  The run's last
    ``process_ready`` takes it up before that call's batch, so every
    query is answered in the run and none waits out two batches."""
    mod = _script()
    seconds, stall = 2.7, 1.2
    engine, out = mod.run(2, StallingVLM(stall), make_embed_client("hash"),
                          seconds, realtime=True)
    asked = mod.queries(2, seconds)
    assert out["queries_served"] == len(asked) == len(out["query_waits_ms"])
    assert all(fut.done() for _, fut in engine.submitted)
    assert out["query_under_load_p95_ms"] >= 0.5 * stall * 1e3
    assert max(out["query_waits_ms"]) < 2 * stall * 1e3
