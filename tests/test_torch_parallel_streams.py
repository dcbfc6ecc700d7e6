"""The stream engine and the HTTP server across ranks under the rank-0
leader (``vidgraph_tpu_torch/parallel/leader.py``), on 2 gloo ranks and at
a world of one.

The ranks run ``tests/torch_leader_cases.py``: ``test_torch_streams.py``'s
two-stream run, lag shedding and live KG with the memories row-sharded
over "data", the ``tiny64`` VLM over a "model" axis of both ranks under
the engine, ``test_torch_server.py``'s requests, ``/v1/retrieve`` of a
graph persisted after the server started, an idle follower on a control
group whose timeout is shorter than its idle, a leader that fails outside
a step, and a follower whose handler raises where the leader's does not.
The JAX side runs in this process on the conftest's 8 virtual devices,
its serving mesh on: the two-stream run, the server, and the
tensor-parallel caption.  Criteria: rank 0's results equal a world of one's and the JAX
package's on its mesh; every follower holds what rank 0 holds; every
session ends with every rank returning; a divergence fails both ranks
well inside ``run_ranks``' deadline.
"""
import itertools
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from test_torch_server import REQUESTS, _assert_same, _serve  # noqa: E402
from torch_leader_cases import persist_graph  # noqa: E402
from test_torch_streams import (PKGS, _two_stream_run,  # noqa: E402
                                assert_hits_equal, color_source, untimed)

from vidgraph_tpu.models import checkpoint as jck  # noqa: E402
from vidgraph_tpu.parallel import serving as jserving  # noqa: E402
from vidgraph_tpu.services.vlm_client import TPUVLMClient as JVLM  # noqa
from vidgraph_tpu_torch.parallel.launch import run_ranks  # noqa: E402

TESTS = str(Path(__file__).parent)
QUERIES = [(2.5, "cam0", "is there a red object"),
           (2.5, "cam1", "is there a blue object"),
           (3.5, "cam0", "a blue object")]
FRAMES = [np.full((48, 48, 3), v, np.uint8) for v in (40, 200)]
RETRIEVES = [("POST", "/v1/retrieve", {"graph_uuid": "srv",
                                       "query": "who holds the beaker?"}),
             ("POST", "/v1/retrieve", {"graph_uuid": "srv",
                                       "query": "what is on the balance?",
                                       "groundtruth": "a person"}),
             ("GET", "/v1/stats", None)]
IDLE = {"timeout_s": 3.0, "idle_s": 7.0}
DEADLINE_S = 120.0


def _bank(color, seed=0):
    return list(itertools.islice(color_source(color, seed=seed), 8))


def _runs(tmp: Path) -> dict:
    """The four rank runs, side by side, while this process computes the
    JAX side."""
    src = persist_graph(str(tmp / "graph_src"))
    inputs = {"red": _bank("red"), "blue": _bank("blue", seed=1),
              "blue2": _bank("blue", seed=2), "green": _bank("green"),
              "queries": QUERIES, "frames": FRAMES, "requests": REQUESTS,
              "retrieves": RETRIEVES, "graph_src": src,
              "graph_dir": {w: str(tmp / f"graphs_w{w}") for w in (1, 2)},
              "idle": IDLE}
    for d in inputs["graph_dir"].values():
        os.makedirs(d)
    jc = JVLM(preset="tiny64", seed=3)
    inputs["vlm_npz"] = str(tmp / "vlm.npz")
    jck.save_params({"vit": jc.vit_params, "cap": jc.cap_params},
                    inputs["vlm_npz"])

    def ranks(target, world, args):
        t = time.perf_counter()
        try:
            out = run_ranks(f"torch_leader_cases:{target}", world, (args,),
                            pythonpath=[TESTS], deadline_s=DEADLINE_S)
        except RuntimeError as e:
            out = e
        return out, time.perf_counter() - t

    with ThreadPoolExecutor(4) as pool:
        two = pool.submit(ranks, "leader_cases", 2, inputs)
        one = pool.submit(ranks, "leader_cases", 1, inputs)
        diverged = {where: pool.submit(ranks, "diverging_follower", 2, {
            "where": where, "requests": REQUESTS})
            for where in ("after", "before")}
        jax_side = _jax_side(inputs["vlm_npz"])
        two, one = two.result()[0], one.result()[0]
        diverged = {k: f.result() for k, f in diverged.items()}
    for run in (two, one):
        if isinstance(run, Exception):
            raise run
    return {"jax": jax_side, "two": two, "one": one[0],
            "diverged": diverged}


def _jax_side(vlm_npz: str) -> dict:
    """The JAX package on its serving mesh over the 8 virtual devices."""
    out = {}
    try:
        jserving.configure(enabled=True, model_axis=2)
        tp = JVLM(preset="tiny64", checkpoint=vlm_npz, max_new=16)
        assert tp._mesh is not None
        out["vlm_tp"] = tp.caption_batch_sync([FRAMES])
        jserving.configure(enabled=True, model_axis=1)
        engine, table = _two_stream_run(PKGS["jax"], QUERIES)
        out["two_streams"] = {"table": untimed(table),
                              "captions": dict(engine.captions)}
        out["server"] = _serve("jax", REQUESTS)
    finally:
        jserving.configure(enabled="auto", model_axis=1)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(tmp_path_factory.mktemp("leader"))


def _lead_and_follower(runs):
    lead, follower = runs["two"]
    assert (lead["rank"], follower["rank"]) == (0, 1)
    return lead, follower


def test_two_streams_equal_world_one_and_jax_mesh(runs):
    lead, follower = _lead_and_follower(runs)
    got, one = lead["two_streams"], runs["one"]["two_streams"]
    jax_side = runs["jax"]["two_streams"]
    assert got["memory_type"] == "ShardedEmbeddingStore"
    assert got["table"] == one["table"] == jax_side["table"]
    assert got["table"]["queries_served"] == 3
    assert got["captions"] == one["captions"] == jax_side["captions"]
    assert len(got["answers"]) == len(one["answers"]) == 3
    for g, r in zip(got["answers"], one["answers"]):
        assert g["stream"] == r["stream"] and g["query"] == r["query"]
        assert_hits_equal(g["chunks"], r["chunks"])
    # the follower ran every step: the same captions and memories
    f = follower["two_streams"]
    assert f["stop"] == "end"
    assert f["captions"] == got["captions"]
    assert f["memory"] == got["memory"]
    assert all(len(ids) >= 3 for ids in got["memory"].values())


def test_lag_shedding_equal_world_one_and_followers_hold_the_kept(runs):
    lead, follower = _lead_and_follower(runs)
    got, one = lead["lag_shedding"], runs["one"]["lag_shedding"]
    assert got["shed"] == one["shed"] == 2 and got["done"] == 2
    assert got["memory"] == one["memory"] == {"s0": ["s0_2", "s0_3"]}
    # the shedder ran on rank 0 only; the follower holds what it kept
    assert follower["lag_shedding"]["shed"] == 0
    assert follower["lag_shedding"]["memory"] == got["memory"]
    assert follower["lag_shedding"]["captions"] == got["captions"]


def test_live_kg_graphs_equal_world_one(runs):
    lead, follower = _lead_and_follower(runs)
    got, one = lead["live_kg"], runs["one"]["live_kg"]
    assert got["table"] == one["table"]
    assert got["graphs"] == one["graphs"]
    for sid in ("cam0", "cam1"):
        assert got["graphs"][sid]["nodes"] > 0
        assert got["graphs"][sid]["rels"] > 0
        assert got["graphs"][sid]["chunks"]["with_embedding"] > 0
    assert follower["live_kg"]["graphs"] == got["graphs"]
    assert follower["live_kg"]["captions"] == got["captions"]


def test_tensor_parallel_caption_under_the_engine_equals_jax(runs):
    want = runs["jax"]["vlm_tp"]
    for rank in runs["two"]:
        assert rank["vlm"]["model_axis"] == 2
        assert rank["vlm"]["captions"] == want
    assert runs["one"]["vlm"]["captions"] == want


def test_server_responses_equal_world_one_and_jax_mesh(runs):
    lead, follower = _lead_and_follower(runs)
    got = lead["server"]["responses"]
    _assert_same(got, runs["one"]["server"]["responses"])
    _assert_same(got, runs["jax"]["server"])
    codes = [c for c, _ in got]
    assert codes[-4:] == [200, 400, 404, 200]
    assert follower["server"]["stop"] == "end"
    assert follower["server"]["memory"] == lead["server"]["memory"]
    assert follower["server"]["served"] >= 6


def test_retrieve_of_a_graph_persisted_after_start(runs):
    lead, follower = _lead_and_follower(runs)
    got = lead["retrieve"]["responses"]
    ref = runs["one"]["retrieve"]["responses"]
    for (gc, g), (rc, r) in zip(got, ref):
        assert gc == rc == 200
        assert set(g) == set(r)
        for k in r:
            if k not in ("time", "retrieval_time", "latency_ms"):
                assert g[k] == r[k], k
    assert got[0][1]["retrieval"].startswith("Found results")
    assert got[2][1]["graphs_open"] == ["srv"]
    assert follower["retrieve"]["graphs_open"] == ["srv"]


def test_idle_follower_outlives_the_group_timeout(runs):
    lead, follower = _lead_and_follower(runs)
    timeout_ms = IDLE["timeout_s"] * 1e3
    for rank in (lead, follower):
        assert rank["idle"]["seconds"] > IDLE["idle_s"] > IDLE["timeout_s"]
        assert rank["idle"]["messages"]["heartbeat"] >= \
            IDLE["idle_s"] / IDLE["timeout_s"]
    assert follower["idle"]["stop"] == "end"
    assert follower["idle"]["wait_ms"]["max"] < timeout_ms
    assert lead["idle"]["responses"][0][0] == 200


def test_every_rank_returns_after_stop(runs):
    lead, follower = _lead_and_follower(runs)
    for case in ("two_streams", "server", "retrieve", "idle"):
        assert follower[case]["stop"] == "end", case
    # a leader that fails outside a step still ends its followers' loop
    assert lead["stop_on_error"] == "the leader's frame source failed"
    assert follower["stop_on_error"] == "ValueError"
    messages = lead["channel"]["messages"]
    assert messages["stop"] == follower["channel"]["messages"]["stop"] == 7
    assert messages == follower["channel"]["messages"]
    assert lead["channel"]["bytes"] == follower["channel"]["bytes"]
    assert runs["one"]["channel"]["world"] == 1


@pytest.mark.parametrize("where", ["after", "before"])
def test_a_diverging_follower_ends_the_world(runs, where):
    """Rank 1's handler raises where rank 0's does not: after its search
    both ranks compare outcomes and raise; before it, rank 0 waits in the
    search's all-gather, rank 1 ends its process after the leader
    module's ``DIVERGENCE_WAIT_S`` and rank 0's collective fails."""
    error, seconds = runs["diverged"][where]
    assert isinstance(error, RuntimeError), error
    assert "ranks [0, 1] failed" in str(error), str(error)[-2000:]
    if where == "after":
        assert "RankDivergence" in str(error)
    else:
        assert "ending this process" in str(error)
    assert seconds < DEADLINE_S / 2, seconds


@pytest.mark.parametrize("device,error", [
    (None, "torch.cuda.is_available() is false"),
    ("cpu", "needs a rendezvous")])
def test_the_channel_raises_where_its_group_cannot_start(device, error):
    """A rank of a launched world of 2 with no rendezvous: building the
    control channel raises, on the default device (``cuda``, absent here)
    and on the CPU; it neither falls back to the CPU nor starts a world
    of one.  Run in a fresh interpreter, with no group initialised."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "VIDGRAPH_TORCH_DEVICE")}
    env.update(WORLD_SIZE="2", RANK="1")
    if device:
        env["VIDGRAPH_TORCH_DEVICE"] = device
    proc = subprocess.run(
        [sys.executable, "-c", "from vidgraph_tpu_torch.parallel.leader "
         "import ControlChannel; ControlChannel()"],
        env=env, cwd=Path(TESTS).parent, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and error in proc.stderr, proc.stderr[-2000:]
