"""The port's live multi-stream runtime against the JAX package's.

``tests/test_streams.py`` and ``tests/test_stream_ingest.py``'s cases run
on both packages with the deterministic ``LocalVLMClient`` and
``LocalChatClient`` and the same seeded frames: frame-ring chunking,
drop-oldest, lag shedding, background KG extraction, the live KG and the
live hybrid query.  Summaries (timings aside), captions, chunk ids, query
hits and live-graph counts must be equal; scores within 1e-5 (float32
products in another order).  The wall-clock overload case cannot give
equal counts run to run, so both packages are held to its invariants.
"""
import asyncio
import os
import types

os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import vidgraph_tpu.core.config as jcfg  # noqa: E402
import vidgraph_tpu.graph.embedded as jemb  # noqa: E402
import vidgraph_tpu.services.embed_client as jec  # noqa: E402
import vidgraph_tpu.services.llm_client as jllm  # noqa: E402
import vidgraph_tpu.services.vlm_client as jvlm  # noqa: E402
import vidgraph_tpu.streams as jstreams  # noqa: E402
import vidgraph_tpu_torch.core.config as tcfg  # noqa: E402
import vidgraph_tpu_torch.graph.embedded as temb  # noqa: E402
import vidgraph_tpu_torch.services.embed_client as tec  # noqa: E402
import vidgraph_tpu_torch.services.llm_client as tllm  # noqa: E402
import vidgraph_tpu_torch.services.vlm_client as tvlm  # noqa: E402
import vidgraph_tpu_torch.streams as tstreams  # noqa: E402

SCORE_TOL = 1e-5
TIMING_KEYS = {"chunk_latency_p50_ms", "query_p50_ms", "query_p95_ms",
               "wall_seconds", "aggregate_fps", "realtime_factor",
               "latency_ms"}

PKGS = {
    "jax": types.SimpleNamespace(
        streams=jstreams, embed=jec.make_embed_client,
        vlm=jvlm.LocalVLMClient, chat=jllm.LocalChatClient,
        config=jcfg.PipelineConfig, store=jemb.EmbeddedGraphStore),
    "torch": types.SimpleNamespace(
        streams=tstreams, embed=tec.make_embed_client,
        vlm=tvlm.LocalVLMClient, chat=tllm.LocalChatClient,
        config=tcfg.PipelineConfig, store=temb.EmbeddedGraphStore),
}


def both(fn):
    """``fn(package namespace)`` for the JAX package and the port."""
    return fn(PKGS["jax"]), fn(PKGS["torch"])


def untimed(x):
    """``x`` with every timing field dropped, recursively."""
    if isinstance(x, dict):
        return {k: untimed(v) for k, v in x.items() if k not in TIMING_KEYS}
    if isinstance(x, list):
        return [untimed(v) for v in x]
    return x


def assert_hits_equal(got, ref):
    """Query hits: the same chunks in the same order with scores within
    ``SCORE_TOL``; among hits whose scores tie, any order."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert abs(g["score"] - r["score"]) <= SCORE_TOL, (g, r)
    key = [(round(r["score"], 4), r["content"]) for r in ref]
    assert [(round(g["score"], 4), g["content"]) for g in got] == key
    strip = [{k: v for k, v in h.items() if k != "score"} for h in got]
    assert sorted(map(repr, strip)) == sorted(
        repr({k: v for k, v in h.items() if k != "score"}) for h in ref)


def color_source(color, h=48, w=64, n=10_000, seed=0):
    """Frames of a coloured square on a seeded noisy background."""
    rgb = {"red": (200, 30, 30), "blue": (30, 30, 200),
           "green": (30, 200, 30)}[color]
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(8):
        frame = rng.integers(0, 40, (h, w, 3), dtype=np.uint8)
        frame[8:40, 16 + i:48 + i] = rgb
        frames.append(frame)
    for i in range(n):
        yield frames[i % len(frames)]


def make_spec(p, sid, fps=10.0):
    return p.streams.StreamSpec(stream_id=sid, fps=fps,
                                chunk_size_seconds=1.0, frames_per_chunk=3,
                                height=48, width=64)


def test_frame_ring_chunking_and_drop_oldest_equal():
    def run(p):
        spec = make_spec(p, "s0", fps=4.0)     # 4 frames a 1 s window
        ring = p.streams.FrameRing(spec, windows=2)   # capacity 8
        out = [ring.pop_chunk()]
        for i, frame in enumerate(color_source("red", n=20, seed=1)):
            ring.push(frame)
            if i in (3, 9):
                out.append(ring.pop_chunk())
        while (item := ring.pop_chunk()) is not None:
            out.append(item)
        return ring.dropped, ring.capacity, out
    (jd, jcap, jout), (td, tcap, tout) = both(run)
    assert (td, tcap) == (jd, jcap) and td > 0
    assert jout[0] is None and tout[0] is None
    assert len(tout) == len(jout) > 2
    for t, j in zip(tout[1:], jout[1:]):
        assert t[:2] == j[:2]
        assert t[2].shape == (3, 48, 64, 3)
        assert np.array_equal(t[2], j[2])


def _two_stream_run(p, queries, seconds=4.0):
    engine = p.streams.RealtimeEngine(
        [make_spec(p, "cam0"), make_spec(p, "cam1")],
        embed_client=p.embed("tpu", dim=64), vlm_client=p.vlm())
    sources = {"cam0": color_source("red"),
               "cam1": color_source("blue", seed=1)}
    out = asyncio.run(p.streams.simulate(engine, sources,
                                         video_seconds=seconds,
                                         queries=queries))
    return engine, out


def test_multi_stream_simulation_equal():
    queries = [(2.5, "cam0", "is there a red object"),
               (2.5, "cam1", "is there a blue object"),
               (3.5, "cam0", "a blue object")]
    (je, jout), (te, tout) = both(lambda p: _two_stream_run(p, queries))
    assert untimed(tout) == untimed(jout)
    assert tout["queries_served"] == 3
    assert tout["query_p50_ms"] is not None
    for sid in ("cam0", "cam1"):
        assert tout["streams"][sid]["chunks_done"] >= 3
        assert tout["streams"][sid]["dropped_frames"] == 0
        assert te.captions[sid] == je.captions[sid]
        assert len(te.memories[sid]) == len(je.memories[sid])
    assert any("red" in c["content"] for c in te.captions["cam0"].values())


@pytest.mark.parametrize("sid,text,k", [
    ("cam1", "a blue object in view", 3), ("cam0", "red shape", 2),
    ("cam0", "nothing like it", 5)])
def test_query_hits_right_stream_equal(sid, text, k):
    def run(p):
        engine, _ = _two_stream_run(p, [], seconds=3.0)
        return asyncio.run(engine.query(sid, text, k=k))
    ref, got = both(run)
    assert untimed(got)["query"] == ref["query"] and got["stream"] == sid
    assert_hits_equal(got["chunks"], ref["chunks"])
    assert all(c["id"].startswith(f"{sid}_") for c in got["chunks"])


def test_lag_shedding_equal():
    def run(p):
        spec = make_spec(p, "s0", fps=4.0)
        out = []
        for lag in (2, None):
            eng = p.streams.RealtimeEngine([spec],
                                           embed_client=p.embed("tpu", 32),
                                           max_lag_windows=lag)
            for frame in color_source("green", n=16):
                eng.push_frame("s0", frame)
            ready = eng._collect_ready_chunks()
            out.append(([(r[0], r[1], r[2]) for r in ready],
                        [r[3] for r in ready], eng.stats["s0"].shed_chunks))
        return out
    ref, got = both(run)
    assert [r[1] for r in got[0][0]] == [2, 3] and got[0][2] == 2
    assert len(got[1][0]) == 4 and got[1][2] == 0
    for g, r in zip(got, ref):
        assert g[0] == r[0] and g[2] == r[2]
        assert all(np.array_equal(a, b) for a, b in zip(g[1], r[1]))


def test_overload_degrades_gracefully_in_both():
    """Wall-clock overload: both packages shed or drop, still complete
    chunks, and keep the realtime factor near 1."""
    class SlowEmbed:
        dim = 32

        async def aembed(self, texts):
            await asyncio.sleep(0.25)
            return np.zeros((len(texts), 32), np.float32)

        async def aembed_query(self, text):
            return np.zeros(32, np.float32)

    def run(p):
        spec = p.streams.StreamSpec("cam0", fps=40.0,
                                    chunk_size_seconds=0.1,
                                    frames_per_chunk=2, height=16, width=16)
        eng = p.streams.RealtimeEngine([spec], embed_client=SlowEmbed(),
                                       max_lag_windows=2)
        frame = np.zeros((16, 16, 3), np.uint8)
        return asyncio.run(p.streams.simulate(
            eng, {"cam0": iter([frame] * 10_000)}, video_seconds=2.0,
            realtime=True))
    for out in both(run):
        s = out["streams"]["cam0"]
        assert s["shed_chunks"] > 0 or s["dropped_frames"] > 0
        assert out["total_shed_chunks"] == s["shed_chunks"]
        assert s["chunks_done"] > 0
        assert out["realtime_factor"] > 0.6


def test_background_kg_extraction_equal():
    def run(p):
        extracted = []

        async def kg_extract(sid, cid, caption, label):
            extracted.append((sid, cid, caption, label))

        eng = p.streams.RealtimeEngine(
            [make_spec(p, "cam0")], embed_client=p.embed("tpu", dim=64),
            vlm_client=p.vlm(), kg_extractor=kg_extract)
        asyncio.run(p.streams.simulate(eng, {"cam0": color_source("green")},
                                       video_seconds=3.0))
        return extracted, eng.stats["cam0"].chunks_done
    (jx, jn), (tx, tn) = both(run)
    assert tx == jx and tn == jn == len(tx) > 0


def _live_kg(p, hybrid_query=None, seconds=6.0):
    cfg = p.config()
    cfg.backend.llm = "local"
    cfg.kg.batch_size = 2
    cfg.llm_injector.subgraph_extraction_injection = False
    cfg.retrieval.entity_first = False
    cfg.retrieval.post_compression = False
    cfg.retrieval.use_reranker = False
    embed = p.embed("tpu", dim=64)
    ingestor = p.streams.LiveKGIngestor(
        cfg, p.chat(), embed,
        store_factory=lambda sid: p.store(sid, persist_dir=None,
                                          persist=False, dim=64))
    specs = [p.streams.StreamSpec(sid, fps=10.0, chunk_size_seconds=1.0,
                                  frames_per_chunk=3, height=48, width=64)
             for sid in ("cam0", "cam1")]
    engine = p.streams.RealtimeEngine(
        specs, embed_client=embed, vlm_client=p.vlm(),
        retrieval_config=cfg.retrieval, kg_extractor=ingestor)

    async def run():
        out = await p.streams.simulate(
            engine, {"cam0": color_source("red"),
                     "cam1": color_source("blue", seed=2)},
            video_seconds=seconds)
        await ingestor.flush()
        res = None
        if hybrid_query is not None:
            engine.attach_graph_store("cam0", ingestor.stores["cam0"])
            res = await engine.query("cam0", hybrid_query)
        return out, res
    out, res = asyncio.run(run())
    graphs = {sid: {"nodes": s.get_node_count(),
                    "rels": s.get_relationship_count(),
                    "chunks": s.get_chunk_counts(),
                    "entities": sorted(s.entities),
                    "fulltext": [e["name"] for e in
                                 s.fulltext_search_entities(
                                     "red shape object", top_k=5)]}
              for sid, s in ingestor.stores.items()}
    ingestor.close()
    return untimed(out), graphs, res


def test_live_kg_from_streams_equal():
    (jout, jg, _), (tout, tg, _) = both(_live_kg)
    assert tout == jout
    assert tg == jg
    for sid in ("cam0", "cam1"):
        assert tg[sid]["nodes"] > 0 and tg[sid]["rels"] > 0
        assert tg[sid]["chunks"]["with_embedding"] > 0
    assert tg["cam0"]["fulltext"]


def test_live_hybrid_query_equal():
    q = "is there a red shape object?"
    (_, _, ref), (_, _, got) = both(lambda p: _live_kg(p, q, seconds=5.0))
    assert got["retrieval"].startswith("Found results for")
    assert "Related Entities" in got["retrieval"] or \
        "Chunks (" in got["retrieval"]
    assert untimed(got) == untimed(ref)


def test_video_frame_source_equal(tmp_path):
    from vidgraph_tpu.io.video import write_synthetic_video

    path = write_synthetic_video(str(tmp_path / "v.mp4"), ["red", "blue"],
                                 seconds_per_scene=1.0, fps=5)
    ref = list(jstreams.video_frame_source(path))
    got = list(tstreams.video_frame_source(path))
    assert len(got) == len(ref) == 10 and got[0].shape == (240, 320, 3)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    looped = tstreams.video_frame_source(path, loop=True)
    assert len([next(looped) for _ in range(25)]) == 25


def test_streams_package_exports():
    assert set(jstreams.__all__) < set(tstreams.__all__)
    assert set(tstreams.__all__) - set(jstreams.__all__) == \
        {"ContinuousBatcher"}
