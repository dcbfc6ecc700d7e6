"""What the ranks of ``tests/test_torch_parallel_streams.py`` run: the
stream engine and the HTTP server across ranks under the rank-0 leader
(``vidgraph_tpu_torch/parallel/leader.py``).

Each function runs on every rank of a gloo group started by
``vidgraph_tpu_torch.parallel.launch.run_ranks``: rank 0 leads each
session, the other ranks follow it, and every rank returns what it holds
afterwards (captions, memories, graphs, its channel's counts).  The test
module compares them with each other, with a world of one's and with the
JAX package's.  This module imports torch and the port only: the ranks
must not import JAX.
"""
from __future__ import annotations

import asyncio
import json
import shutil
import time
from pathlib import Path

from vidgraph_tpu_torch.core.config import PipelineConfig
from vidgraph_tpu_torch.parallel import serving
from vidgraph_tpu_torch.parallel.leader import (ControlChannel,
                                                RankedEngine, RankedServer,
                                                follow_server, follow_stream,
                                                session)
from vidgraph_tpu_torch.services.embed_client import make_embed_client
from vidgraph_tpu_torch.streams import StreamSpec, simulate

TIMING_KEYS = {"chunk_latency_p50_ms", "query_p50_ms", "query_p95_ms",
               "wall_seconds", "aggregate_fps", "realtime_factor",
               "latency_ms"}


def untimed(x):
    """``x`` with every timing field dropped, recursively."""
    if isinstance(x, dict):
        return {k: untimed(v) for k, v in x.items() if k not in TIMING_KEYS}
    if isinstance(x, list):
        return [untimed(v) for v in x]
    return x


def _source(bank):
    """An endless iterator over ``bank``'s frames."""
    i = 0
    while True:
        yield bank[i % len(bank)]
        i += 1


def _spec(sid, fps=10.0):
    return StreamSpec(stream_id=sid, fps=fps, chunk_size_seconds=1.0,
                      frames_per_chunk=3, height=48, width=64)


def _held(engine) -> dict:
    """What an engine holds: each stream's captions and memory ids."""
    return {"captions": {sid: dict(c) for sid, c in engine.captions.items()},
            "memory": {sid: m.ids() for sid, m in engine.memories.items()}}


def _stream_session(engine, lead):
    """Rank 0 runs ``lead()`` in a session; a follower follows it.
    Returns what ``lead`` returned, or the follower's stop reason."""
    async def run():
        if not engine.channel.leader:
            return await follow_stream(engine)
        with session(engine.channel):
            return await lead()
    return asyncio.run(run())


async def _http(port, method, path, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode() if body is not None else b""
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(payload)}\r\n"
                  f"Connection: close\r\n\r\n").encode() + payload)
    await writer.drain()
    out = await reader.read()
    writer.close()
    head, _, resp_body = out.partition(b"\r\n\r\n")
    if not head:
        return None, None
    return int(head.split(b" ")[1]), json.loads(resp_body)


def _server_session(server, requests, before=None, idle_s=0.0):
    """Rank 0 serves ``requests`` over HTTP (``before()`` once it
    listens, then ``idle_s`` idle) and returns the responses; a follower
    follows and returns its stop reason."""
    async def lead():
        await server.start()
        try:
            if before is not None:
                before()
            await asyncio.sleep(idle_s)
            return [await _http(server.port, m, p, b)
                    for m, p, b in requests]
        finally:
            await server.stop()
    if server.channel.leader:
        return asyncio.run(lead())
    return asyncio.run(follow_server(server))


def _server_config(graph_dir=None) -> PipelineConfig:
    cfg = PipelineConfig()
    cfg.backend.llm = "local"
    if graph_dir is not None:
        cfg.graph_store.persist_dir = graph_dir
    return cfg


def persist_graph(persist_dir: str) -> str:
    """Persist the graph "srv" of ``test_torch_server.py`` to
    ``persist_dir``, its chunks with the hash embedder's vectors (so that
    a retrieval searches them), computed on the CPU."""
    import os

    from vidgraph_tpu_torch.core.platform import DEVICE_ENV
    from vidgraph_tpu_torch.graph.embedded import EmbeddedGraphStore

    before = os.environ.get(DEVICE_ENV)
    os.environ[DEVICE_ENV] = "cpu"
    try:
        embed = make_embed_client("tpu", dim=512)
        chunks = [{"id": "srv_0_0", "content": "person holds a beaker",
                   "index": 0},
                  {"id": "srv_0_1", "content": "the beaker is on a balance",
                   "index": 1}]
        for c, vec in zip(chunks, embed.embed([c["content"]
                                               for c in chunks])):
            c["embedding"] = [float(x) for x in vec]
        store = EmbeddedGraphStore("srv", persist_dir=persist_dir, dim=512)
        store.add_batch_to_graph(
            [{"head": "Person", "relation": "holds", "tail": "Beaker",
              "source_chunks": ["srv_0_0"]},
             {"head": "Beaker", "relation": "is_on", "tail": "Balance",
              "source_chunks": ["srv_0_1"]}],
            [{"time": "00:00-00:04", "content": "x"}], 0,
            text_chunks=chunks)
        assert store.get_chunk_counts()["with_embedding"] == 2
        store.close()
    finally:
        if before is None:
            del os.environ[DEVICE_ENV]
        else:
            os.environ[DEVICE_ENV] = before
    return persist_dir


# ------------------------------------------------------------------- cases
def two_streams(ch, inputs):
    """``test_torch_streams.py``'s two-stream run with its queries, the
    memories row-sharded over "data"."""
    from vidgraph_tpu_torch.services.vlm_client import LocalVLMClient

    serving.configure(enabled=True, model_axis=1)
    engine = RankedEngine([_spec("cam0"), _spec("cam1")],
                          embed_client=make_embed_client("tpu", dim=64),
                          vlm_client=LocalVLMClient(), channel=ch)
    asked, submit = [], engine.submit_query

    def kept(sid, text):
        fut = submit(sid, text)
        asked.append(fut)
        return fut
    engine.submit_query = kept

    async def lead():
        return await simulate(engine, {"cam0": _source(inputs["red"]),
                                       "cam1": _source(inputs["blue"])},
                              video_seconds=4.0, queries=inputs["queries"])
    got = _stream_session(engine, lead)
    rec = {**_held(engine), "memory_type": type(
        engine.memories["cam0"]).__name__}
    if ch.leader:
        rec.update(table=untimed(got),
                   answers=[untimed(f.result()) for f in asked])
    else:
        rec["stop"] = got
    return rec


def lag_shedding(ch, inputs):
    """16 frames pushed at once into a stream of 4-frame windows that
    keeps 2: the leader sheds the 2 oldest and broadcasts the rest."""
    serving.configure(enabled=True, model_axis=1)
    engine = RankedEngine([_spec("s0", fps=4.0)],
                          embed_client=make_embed_client("tpu", dim=32),
                          max_lag_windows=2, channel=ch)

    async def lead():
        for i in range(16):
            engine.push_frame("s0", inputs["green"][i % len(inputs["green"])])
        return await engine.process_ready()
    got = _stream_session(engine, lead)
    return {**_held(engine), "shed": engine.stats["s0"].shed_chunks,
            "done": got if ch.leader else None}


def live_kg(ch, inputs):
    """``test_torch_streams.py``'s live-KG run with subgraph injection
    on: each stream's captions through ``LiveKGIngestor`` on
    the local chat client, the graphs' chunk vectors row-sharded, so that
    each KG batch's similarity to the graph's chunks is an all-gather over
    "data"; the last batches by ``flush_kg``."""
    from vidgraph_tpu_torch.graph.embedded import EmbeddedGraphStore
    from vidgraph_tpu_torch.services.llm_client import LocalChatClient
    from vidgraph_tpu_torch.services.vlm_client import LocalVLMClient
    from vidgraph_tpu_torch.streams import LiveKGIngestor

    serving.configure(enabled=True, model_axis=1)
    cfg = PipelineConfig()
    cfg.backend.llm = "local"
    cfg.kg.batch_size = 2
    cfg.llm_injector.subgraph_extraction_injection = True
    cfg.retrieval.entity_first = False
    cfg.retrieval.post_compression = False
    cfg.retrieval.use_reranker = False
    embed = make_embed_client("tpu", dim=64)
    ingestor = LiveKGIngestor(
        cfg, LocalChatClient(), embed,
        store_factory=lambda sid: EmbeddedGraphStore(
            sid, persist_dir=None, persist=False, dim=64))
    engine = RankedEngine([_spec("cam0"), _spec("cam1")],
                          embed_client=embed, vlm_client=LocalVLMClient(),
                          retrieval_config=cfg.retrieval,
                          kg_extractor=ingestor, channel=ch)

    async def lead():
        out = await simulate(engine, {"cam0": _source(inputs["red"]),
                                      "cam1": _source(inputs["blue2"])},
                             video_seconds=6.0)
        await engine.flush_kg()
        return out
    got = _stream_session(engine, lead)
    graphs = {sid: {"nodes": s.get_node_count(),
                    "rels": s.get_relationship_count(),
                    "chunks": s.get_chunk_counts(),
                    "entities": sorted(s.entities)}
              for sid, s in ingestor.stores.items()}
    ingestor.close()
    return {**_held(engine), "graphs": graphs,
            "table": untimed(got) if ch.leader else None}


def tensor_parallel_vlm(ch, inputs):
    """The ``tiny64`` ``TPUVLMClient`` (the JAX package's weights) over a
    "model" axis of every rank under the engine: one chunk of the JAX
    test's two frames."""
    from vidgraph_tpu_torch.parallel import mesh as pm
    from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient

    serving.configure(enabled=True, model_axis=2)
    vlm = TPUVLMClient(preset="tiny64", max_new=16,
                       checkpoint=inputs["vlm_npz"])
    spec = StreamSpec("cam0", fps=2.0, chunk_size_seconds=1.0,
                      frames_per_chunk=2, height=48, width=48)
    engine = RankedEngine([spec], embed_client=make_embed_client("tpu", 64),
                          vlm_client=vlm, channel=ch)

    async def lead():
        for frame in inputs["frames"]:
            engine.push_frame("cam0", frame)
        return await engine.process_ready()
    _stream_session(engine, lead)
    return {"captions": [c["content"]
                         for c in engine.captions["cam0"].values()],
            "model_axis": pm.axis_size(vlm._mesh, "model")}


def server_requests(ch, inputs):
    """``test_torch_server.py``'s ``REQUESTS`` through ``RankedServer``,
    the memories row-sharded over "data"."""
    serving.configure(enabled=True, model_axis=1)
    server = RankedServer(_server_config(), port=0, channel=ch)
    got = _server_session(server, inputs["requests"])
    return {"responses" if ch.leader else "stop": got,
            "served": server.requests_served,
            "memory": {sid: m.ids() for sid, m in server.memories.items()}}


def retrieve_after_start(ch, inputs):
    """``/v1/retrieve`` of a graph that rank 0 persists after the server
    started; every rank reads rank 0's graph directory."""
    serving.configure(enabled=True, model_axis=1)
    graph_dir = inputs["graph_dir"][ch.world]
    server = RankedServer(_server_config(graph_dir), port=0, channel=ch)

    def persist():
        for f in Path(inputs["graph_src"]).iterdir():
            shutil.copy(f, graph_dir)
    got = _server_session(server, inputs["retrieves"], before=persist)
    return {"responses" if ch.leader else "stop": got,
            "graphs_open": sorted(server.retrievers)}


def idle_follower(inputs):
    """A server idle for ``idle_s`` on a control group whose timeout is
    ``timeout_s``, shorter: the heartbeats keep the follower waiting."""
    serving.configure(enabled=True, model_axis=1)
    ch = ControlChannel(timeout_s=inputs["idle"]["timeout_s"])
    server = RankedServer(_server_config(), port=0, channel=ch)
    t = time.perf_counter()
    got = _server_session(server, inputs["requests"][:1],
                          idle_s=inputs["idle"]["idle_s"])
    return {"responses" if ch.leader else "stop": got,
            "seconds": time.perf_counter() - t, **ch.summary()}


def stop_on_error(ch):
    """The leader fails outside a step: its session still sends STOP."""
    engine = RankedEngine([_spec("s0")],
                          embed_client=make_embed_client("tpu", dim=32),
                          channel=ch)

    async def lead():
        raise ValueError("the leader's frame source failed")
    try:
        return _stream_session(engine, lead)
    except ValueError as e:
        return str(e)


def leader_cases(inputs):
    """Every case, one session each, on one control channel; the idle
    case (a channel of its own) where the world has followers."""
    ch = ControlChannel()
    out = {"rank": ch.rank, "world": ch.world,
           "two_streams": two_streams(ch, inputs),
           "lag_shedding": lag_shedding(ch, inputs),
           "live_kg": live_kg(ch, inputs),
           "vlm": tensor_parallel_vlm(ch, inputs),
           "server": server_requests(ch, inputs),
           "retrieve": retrieve_after_start(ch, inputs),
           "stop_on_error": stop_on_error(ch)}
    if ch.world > 1:
        out["idle"] = idle_follower(inputs)
    out["channel"] = ch.summary()
    serving.configure(enabled="auto", model_axis=1)
    return out


def diverging_follower(inputs):
    """Rank 1's ``/v1/query`` handler raises where rank 0's does not:
    before its search (``where == "before"``: rank 0 then waits in the
    search's all-gather) or after it.  Neither rank may return."""
    serving.configure(enabled=True, model_axis=1)
    ch = ControlChannel()
    server = RankedServer(_server_config(), port=0, channel=ch)
    if ch.rank == 1:
        query = RankedServer.ROUTES["query"]

        async def planted(self, body):
            if inputs["where"] == "after":
                await query(self, body)
            raise RuntimeError("a fault planted on rank 1")
        server.ROUTES = {**RankedServer.ROUTES, "query": planted}
    return _server_session(server, inputs["requests"])
