"""The port's serving mesh against ``tests/test_mesh_serving.py``'s
criteria, on 2 gloo ranks (a (1, 2) mesh, "model" 2) and at a world of
one.

The JAX side runs in this process on the conftest's 8 virtual devices
(tensor-parallel with ``model_axis=2`` and single-device); the port's on
the ranks, with the JAX package's weights (an npz for the ``tiny64`` VLM,
numpy leaves for the chat LM of the JAX test's config).  Criteria: the
policy off / on / auto, the config load, hybrid retrieval through the
mesh equal to one device, the caption and the chat decode token-equal to
the JAX package's (tensor-parallel and single-device), stream memories
row-sharded at a world of one, and ``kg``, ``batch-retrieve`` and
``stream`` through the CLI on two ranks: rank 0 alone writes and prints,
and its ``stream`` JSON equals a world of one's.
"""
import json
import socket
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from vidgraph_tpu.models import checkpoint as jck
from vidgraph_tpu.models.captioner import CaptionerConfig as JCfg
from vidgraph_tpu.models.captioner import init_params as jinit
from vidgraph_tpu.parallel import serving as jserving
from vidgraph_tpu.services.llm_client import TPUChatClient as JChat
from vidgraph_tpu.services.vlm_client import TPUVLMClient as JVLM
from torch_leader_cases import persist_graph
from vidgraph_tpu_torch.io.video import write_synthetic_video
from vidgraph_tpu_torch.parallel.launch import run_ranks

TESTS = str(Path(__file__).parent)
FRAMES = [np.full((48, 48, 3), v, np.uint8) for v in (40, 200)]
PROMPT = "Extract triplets: the person holds a red beaker."
GOLDEN_VLM = Path(__file__).parent / "golden" / "vlm_output_golden.json"
KG_YAML = """\
backend: {vlm: local, llm: local}
kg: {batch_size: 2}
retrieval: {entity_first: false}
graph_store: {persist_dir: gs}
"""
STREAM_YAML = KG_YAML + "video: {chunk_size_seconds: 1.0, frames_per_chunk: 3}\n"
SERVE_REQUESTS = [
    ("POST", "/v1/ingest", {"stream": "cam0", "chunk_id": "cam0_0",
                            "content": "a red beaker on the bench"}),
    ("POST", "/v1/query", {"stream": "cam0", "query": "red beaker"}),
    ("POST", "/v1/retrieve", {"graph_uuid": "srv",
                              "query": "who holds the beaker?"}),
    ("GET", "/v1/stats", None)]
TIMING_KEYS = {"chunk_latency_p50_ms", "query_p50_ms", "query_p95_ms",
               "wall_seconds", "aggregate_fps", "realtime_factor"}


def _jax_side(tmp: Path) -> dict:
    out = {}
    try:
        jc = JVLM(preset="tiny64", seed=3)
        npz = str(tmp / "vlm.npz")
        jck.save_params({"vit": jc.vit_params, "cap": jc.cap_params}, npz)
        jserving.configure(enabled=True, model_axis=2)
        tp = JVLM(preset="tiny64", checkpoint=npz, max_new=16)
        assert tp._mesh is not None
        out["vlm_tp"] = tp.caption_batch_sync([FRAMES])
        jserving.configure(enabled=False)
        out["vlm_single"] = JVLM(preset="tiny64", checkpoint=npz,
                                 max_new=16).caption_batch_sync([FRAMES])
        cfg = JCfg(width=128, layers=2, heads=4, vision_dim=64,
                   num_vision_tokens=2, max_len=640, dtype=jnp.float32)
        params = jinit(cfg, seed=0)
        jserving.configure(enabled=True, model_axis=2)
        out["chat_tp"] = JChat(cfg=cfg, params=params,
                               max_new=16).complete_sync(PROMPT)
        jserving.configure(enabled=False)
        out["chat_single"] = JChat(cfg=cfg, params=params,
                                   max_new=16).complete_sync(PROMPT)
        work = tmp / "cli"
        work.mkdir()
        (work / "kg.yaml").write_text(KG_YAML)
        (work / "stream.yaml").write_text(STREAM_YAML)
        video = write_synthetic_video(str(tmp / "v.mp4"),
                                      ["red", "blue", "green"],
                                      seconds_per_scene=1.0, fps=5)
        (tmp / "queries.json").write_text(json.dumps(
            [{"query": "What color is the shape?", "groundtruth": "red"},
             {"query": "Where is the blue object?", "groundtruth": ""}]))
        out["inputs"] = {"vlm_npz": npz, "chat_params": _numpy(params),
                         "workdir": str(work),
                         "kg_config": str(work / "kg.yaml"),
                         "vlm_output": str(GOLDEN_VLM),
                         "queries": str(tmp / "queries.json"),
                         "stream_config": str(work / "stream.yaml"),
                         "video": video, "serve_port": _free_port(),
                         "graph_src": persist_graph(str(tmp / "graph")),
                         "serve_requests": SERVE_REQUESTS}
    finally:
        jserving.configure(enabled="auto", model_axis=1)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_side = _jax_side(tmp_path_factory.mktemp("serving"))
    two = run_ranks("torch_parallel_cases:serving_cases", 2,
                    (jax_side["inputs"],), pythonpath=[TESTS])
    one = run_ranks("torch_parallel_cases:world_one_cases", 1,
                    (jax_side["inputs"],), pythonpath=[TESTS])[0]
    return jax_side, two, one


def test_policy_off_on_and_auto(runs):
    for rank in runs[1]:
        p = rank["policy"]
        assert p["off"] and p["on_model"] == 2
        assert p["on_store"] == "ShardedEmbeddingStore"
        assert p["off_store"] == "EmbeddingStore"
        # auto at a world of two ranks is on, with model_axis 1
        assert p["auto_shape"] == (2, 1)


def test_config_load_configures_serving(runs):
    for rank in runs[1]:
        assert rank["config"] == {"off": True, "on_model": 2}


def test_hybrid_retrieval_identical_mesh_vs_single(runs):
    for rank in runs[1]:
        (mesh_result, mesh_cls) = rank["retrieval_mesh"]
        (single_result, single_cls) = rank["retrieval_single"]
        assert mesh_cls == "ShardedEmbeddingStore"
        assert single_cls == "EmbeddingStore"
        assert mesh_result == single_result


def test_tpu_vlm_caption_identical_mesh_vs_single_and_jax(runs):
    jax_side, two, _ = runs
    assert jax_side["vlm_tp"] == jax_side["vlm_single"]
    for rank in two:
        on_mesh, qkv_cols, vit_split = rank["vlm_split"]
        # tiny64: width 128, 4 heads; half the heads of q, k, v a rank
        assert on_mesh and qkv_cols == 3 * 128 // 2 and vit_split == "cols"
        assert rank["vlm_tp"] == rank["vlm_single"] == jax_side["vlm_tp"]
        # the fused attention on each rank's 2 local heads
        tp_fused, single_fused = rank["vlm_fused"]
        assert tp_fused == single_fused


def test_tpu_chat_prompt_decode_identical_mesh_vs_single_and_jax(runs):
    jax_side, two, _ = runs
    assert jax_side["chat_tp"] == jax_side["chat_single"]
    for rank in two:
        on_mesh, text = rank["chat_tp"]
        assert on_mesh
        assert text == rank["chat_single"] == jax_side["chat_tp"]


def test_realtime_engine_memories_sharded_at_world_one(runs):
    one = runs[2]
    assert one["before"] is False and one["world"] == 1
    assert one["shape"] == (1, 1)
    assert one["memory"] == "ShardedEmbeddingStore"


def _stream_json(stdout: str) -> dict:
    line, = [ln for ln in stdout.splitlines()
             if ln.startswith("Stream run completed: ")]
    return json.loads(line.split(": ", 1)[1])


def _untimed(x):
    if isinstance(x, dict):
        return {k: _untimed(v) for k, v in x.items() if k not in TIMING_KEYS}
    return x


def test_cli_kg_across_ranks_writes_once_and_refuses_stream_and_serve(runs):
    """``kg`` on two ranks: rank 0 prints the UUID and persists one graph,
    the follower prints nothing and writes nothing beside it; then
    ``batch-retrieve`` of that graph (the follower reads a copy) writes
    one results file and one metrics file.  ``stream``, no longer refused
    across ranks, runs under the rank-0 leader: rank 0 prints one JSON,
    equal to a world of one's but for timings, the follower nothing."""
    lead, follower = (rank["cli"] for rank in runs[1])
    uuid = lead["stdout"].split("UUID: ")[1].split()[0]
    assert follower["stdout"] == ""
    assert lead["graphs"] == follower["graphs"] == [f"{uuid}.emb.npz",
                                                    f"{uuid}.json"]
    # batch-retrieve: rank 0 writes the results and one metrics file
    assert "Batch retrieval completed" in lead["retrieve_stdout"]
    assert follower["retrieve_stdout"] == ""
    assert "retrieval.json" in lead["written"]
    # every metrics file is rank 0's run's (a follower's kg had its own
    # uuid), and one retrieval-times file
    assert lead["metrics"] and all(uuid in m for m in lead["metrics"])
    assert sum(m.startswith("retrieval_times_")
               for m in lead["metrics"]) == 1
    # stream: one JSON on rank 0, equal to a world of one's
    assert follower["stream_stdout"] == ""
    got, one = (_stream_json(lead["stream_stdout"]),
                _stream_json(runs[2]["stream_stdout"]))
    assert lead["stream_stdout"].count("Stream run completed") == 1
    assert _untimed(got) == _untimed(one)
    assert got["queries_served"] == 2
    assert all(s["chunks_done"] == 3 for s in got["streams"].values())
    # serve: rank 0 answers until interrupted; its STOP ends the follower,
    # which read the graph rank 0 persisted after the server started
    lead_serve, follower_serve = lead["serve"], follower["serve"]
    assert lead_serve["interrupted"] and not follower_serve["interrupted"]
    assert follower_serve["rc"] == 0 and follower_serve["stdout"] == ""
    assert follower_serve["responses"] == []
    codes = [code for code, _ in lead_serve["responses"]]
    assert codes == [200] * len(SERVE_REQUESTS)
    _, hits = lead_serve["responses"][1]
    assert [c["id"] for c in hits["chunks"]] == ["cam0_0"]
    _, retrieved = lead_serve["responses"][2]
    assert retrieved["retrieval"].startswith("Found results")
    assert "person holds a beaker" in retrieved["retrieval"]
