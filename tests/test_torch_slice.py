"""The query-serving slice as a whole: the port against the JAX package.

From the same ``vlm_output.json`` (60 chunks, made from a numpy seed) both
packages build a graph with the recall profile (``config/
high_recall_config.yaml``: vector search on, pre-injector similarity on,
word splitter) and NetworkX ACS.  Then graphs must be equal exactly; the
retrieval texts of 10 queries with ``entity_first=False`` equal; ACS
metrics under NetworkX and under ``auto`` (the device sweep, Louvain
included), and the benchmark JSON for one results file equal; and the port
must rebuild ``tests/golden/pipeline_golden.json`` from the committed
``tests/golden/vlm_output_golden.json``.

``tiktoken`` is kept out of these builds (``sys.modules`` entry None):
its encoder would be fetched over the network, and without it both
packages use the same calibrated estimator.
"""
import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import vidgraph_tpu.core.config as jcfg  # noqa: E402
import vidgraph_tpu.graph as jgraph  # noqa: E402
import vidgraph_tpu.pipeline.acs as jacs  # noqa: E402
import vidgraph_tpu.pipeline.benchmark as jbench  # noqa: E402
import vidgraph_tpu.pipeline.kg_builder as jkg  # noqa: E402
import vidgraph_tpu.pipeline.retriever_hybrid as jret  # noqa: E402
import vidgraph_tpu.services.embed_client as jembed  # noqa: E402
import vidgraph_tpu.services.rerank_client as jrerank  # noqa: E402
import vidgraph_tpu_torch.core.config as tcfg  # noqa: E402
import vidgraph_tpu_torch.graph as tgraph  # noqa: E402
import vidgraph_tpu_torch.pipeline.acs as tacs  # noqa: E402
import vidgraph_tpu_torch.pipeline.benchmark as tbench  # noqa: E402
import vidgraph_tpu_torch.pipeline.kg_builder as tkg  # noqa: E402
import vidgraph_tpu_torch.pipeline.retriever_hybrid as tret  # noqa: E402
import vidgraph_tpu_torch.services.embed_client as tembed  # noqa: E402
import vidgraph_tpu_torch.services.rerank_client as trerank  # noqa: E402
from vidgraph_tpu_torch.cli.main import main as cli_main  # noqa: E402

ROOT = Path(__file__).parent.parent
GOLDEN = ROOT / "tests" / "golden"
JAX = dict(cfg=jcfg, graph=jgraph, acs=jacs, bench=jbench, kg=jkg,
           ret=jret, embed=jembed, rerank=jrerank)
PORT = dict(cfg=tcfg, graph=tgraph, acs=tacs, bench=tbench, kg=tkg,
            ret=tret, embed=tembed, rerank=trerank)

_OBJECTS = ["beaker", "flask", "balance", "smartphone", "glove", "pipette",
            "cabinet", "bottle", "notebook", "monitor", "tray", "goggles"]
_COLORS = ["red", "blue", "green", "yellow", "white", "black", "orange"]
_VERBS = ["holds", "places", "weighs", "opens", "examines", "pours",
          "picks up", "moves"]


def make_vlm_output(n_chunks=60, seed=0):
    rng = np.random.default_rng(seed)
    results = []
    for i in range(n_chunks):
        c1, c2 = rng.choice(_COLORS, 2, replace=False)
        o1, o2 = rng.choice(_OBJECTS, 2, replace=False)
        v = rng.choice(_VERBS)
        t0 = i * 5
        results.append({
            "time": f"{t0 // 60:02d}:{t0 % 60:02d}-"
                    f"{(t0 + 4) // 60:02d}:{(t0 + 4) % 60:02d}",
            "content": f"The person {v} the {c1} {o1} on the laboratory "
                       f"bench. A {c2} {o2} sits next to the {c1} {o1}. "
                       f"The scale reads {rng.integers(1, 500)}.5 g.",
            "chunk_idx": i})
    return {"metadata": {"run_id": "slice", "total_chunks": n_chunks},
            "results": results}


QUERIES = [f"What color is the {o}?" for o in _OBJECTS[:7]] + [
    "What does the person pour?", "What does the scale read?",
    "Which object sits next to the flask?"]


def _config(pkg, persist_dir):
    cfg = pkg["cfg"].PipelineConfig.from_yaml(
        str(ROOT / "config" / "high_recall_config.yaml"))
    cfg.backend.vlm = "local"
    cfg.acs.backend = "networkx"
    cfg.graph_store.persist_dir = str(persist_dir)
    return cfg


def _retrieve(pkg, cfg, store, queries):
    embed = pkg["embed"].make_embed_client("tpu",
                                           dim=cfg.embedding_memory.dim)
    rerank = pkg["rerank"].make_rerank_client("tpu", embed_client=embed)
    retriever = pkg["ret"].HybridRetriever(cfg.retrieval, store, embed,
                                           rerank, output_file=None)

    async def run():
        return [(await retriever.perform_hybrid_retrieval(q))[0]
                for q in queries]
    return asyncio.run(run())


def _graph(store):
    return {"entities": sorted(store.entities),
            "rels": sorted("|".join(k) for k in store.rels),
            "from_chunk": sorted(store.from_chunk),
            "chunks": {cid: c.get("content")
                       for cid, c in sorted(store.chunks.items())}}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both packages build the 60-chunk graph, each in its own directory."""
    vlm = tmp_path_factory.mktemp("vlm") / "vlm_output.json"
    vlm.write_text(json.dumps(make_vlm_output()))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tiktoken", None)
        for name, pkg in (("jax", JAX), ("port", PORT)):
            d = tmp_path_factory.mktemp(name)
            mp.chdir(d)
            cfg = _config(pkg, d / "gs")
            builder = pkg["kg"].KGBuilder(cfg, run_uuid="slice")
            asyncio.run(builder.build_knowledge_graph(str(vlm)))
            store = pkg["graph"].open_graph_store(cfg, "slice")
            out[name] = (pkg, cfg, store, d)
    return out


def test_graphs_are_equal(built):
    jax_graph = _graph(built["jax"][2])
    port_graph = _graph(built["port"][2])
    assert len(port_graph["chunks"]) > 0 and len(port_graph["rels"]) > 0
    assert port_graph == jax_graph
    for name in ("jax", "port"):
        assert built[name][2].get_chunk_counts() == \
            built["jax"][2].get_chunk_counts()


def test_chunk_embeddings_agree(built):
    jstore, tstore = built["jax"][2], built["port"][2]
    for cid, c in jstore.chunks.items():
        np.testing.assert_allclose(tstore.chunks[cid]["embedding"],
                                   c["embedding"], atol=1e-6, rtol=0)


def test_retrieval_texts_are_equal(built):
    texts = {}
    for name, (pkg, cfg, store, _d) in built.items():
        cfg.retrieval.entity_first = False
        texts[name] = _retrieve(pkg, cfg, store, QUERIES)
    assert all(texts["port"])
    assert texts["port"] == texts["jax"]


def test_acs_metrics_are_equal(built):
    got = {}
    for name, (pkg, cfg, store, _d) in built.items():
        m = pkg["acs"].ACSAutomata(store, cfg.acs).update_metrics()
        m.pop("computational_time")
        got[name] = m
    assert "error" not in got["port"] and got["port"]["node_count"] > 0
    assert got["port"] == got["jax"]


def test_benchmark_json_is_equal(built, tmp_path):
    pkg, cfg, store, _d = built["port"]
    texts = _retrieve(pkg, cfg, store, QUERIES)
    results = tmp_path / "results.json"
    results.write_text(json.dumps([
        {"query": q, "groundtruth": gt, "retrieval": t}
        for q, t, gt in zip(QUERIES, texts,
                            ["red"] * 4 + ["", "blue"] * 3)]))
    outs = {}
    for name, (pkg, cfg, _s, _d) in built.items():
        path = tmp_path / f"bench_{name}.json"
        asyncio.run(pkg["bench"].BenchmarkEvaluator(cfg)
                    .evaluate_retrieval_results(str(results), str(path)))
        outs[name] = json.loads(path.read_text())
    assert outs["port"]["statistics"]["total_queries"] == len(QUERIES)
    assert outs["port"] == outs["jax"]


def test_port_reads_the_jax_graph_snapshot_and_export(built, tmp_path):
    jpkg, jcfg_, jstore, jdir = built["jax"]
    cfg = _config(PORT, jdir / "gs")
    crossed = tgraph.open_graph_store(cfg, "slice")
    assert _graph(crossed) == _graph(jstore)
    export = tmp_path / "export.json"
    jgraph.GraphExporter(jstore).export_graph(str(export))
    cfg.graph_store.persist_dir = str(tmp_path / "imported")
    uuid = tgraph.GraphImporter(
        lambda u: tgraph.open_graph_store(cfg, u, load_existing=False)
    ).import_graph(str(export), new_uuid="crossed", use_new_uuid=False)
    imported = tgraph.open_graph_store(cfg, uuid)
    assert sorted(imported.entities) == sorted(jstore.entities)
    assert len(imported.rels) == len(jstore.rels)
    assert imported.get_chunk_counts() == jstore.get_chunk_counts()


def test_golden_rebuild(tmp_path):
    golden = json.loads((GOLDEN / "pipeline_golden.json").read_text())
    vlm = json.loads((GOLDEN / "vlm_output_golden.json").read_text())
    assert [it["content"] for it in vlm["results"]] == \
        golden["vlm_contents"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tiktoken", None)
        mp.chdir(tmp_path)
        cfg = tcfg.PipelineConfig()
        cfg.backend.llm = "local"
        cfg.kg.batch_size = 2
        cfg.graph_store.persist_dir = "gs"
        builder = tkg.KGBuilder(cfg, run_uuid="golden")
        asyncio.run(builder.build_knowledge_graph(
            str(GOLDEN / "vlm_output_golden.json")))
        store = tgraph.open_graph_store(cfg, "golden")
    assert sorted(store.entities) == golden["entities"]
    assert sorted("|".join(k) for k in store.rels) == golden["rels"]
    assert sorted(store.chunks) == golden["chunk_ids"]
    assert store.get_chunk_counts() == golden["chunk_counts"]
    assert [e["name"] for e in store.fulltext_search_entities(
        "red shape object", 3)] == golden["fulltext_top"]


def test_cli_kg_batch_retrieve_benchmark(tmp_path, capsys):
    vlm = tmp_path / "vlm.json"
    vlm.write_text(json.dumps(make_vlm_output(9, seed=1)))
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text((ROOT / "config" / "high_recall_config.yaml")
                        .read_text() + "\nacs:\n  backend: networkx\n")
    queries = tmp_path / "q.json"
    queries.write_text(json.dumps([{"query": q, "groundtruth": "red"}
                                   for q in QUERIES[:3]]))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)
        assert cli_main(["kg", "--config", str(cfg_path), "--vlm-output",
                         str(vlm)]) == 0
        uuid = capsys.readouterr().out.strip().rsplit("UUID: ", 1)[1]
        built = json.loads((tmp_path / "graph_store" / f"{uuid}.json")
                           .read_text())
        # a finished build resumes past its last batch and changes nothing
        assert cli_main(["kg", "--config", str(cfg_path), "--vlm-output",
                         str(vlm), "--resume-uuid", uuid]) == 0
        assert uuid in capsys.readouterr().out
        resumed = json.loads((tmp_path / "graph_store" / f"{uuid}.json")
                             .read_text())
        assert resumed["entities"] == built["entities"]
        assert resumed["chunks"] == built["chunks"]
        assert cli_main(["batch-retrieve", "--config", str(cfg_path),
                         "--graph-uuid", uuid, "--input", str(queries),
                         "--output", "r.json"]) == 0
        assert cli_main(["benchmark", "--config", str(cfg_path), "--input",
                         "r.json", "--output", "b.json"]) == 0
        assert cli_main(["ask", "--config", str(cfg_path), "--graph-uuid",
                         uuid, "--query", QUERIES[0]]) == 0
    records = json.loads((tmp_path / "r.json").read_text())
    assert [r["query"] for r in records] == QUERIES[:3]
    assert all(r["retrieval"] for r in records)
    bench = json.loads((tmp_path / "b.json").read_text())
    assert set(bench) == {"statistics", "results"}
    assert bench["statistics"]["total_queries"] == 3


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import vidgraph_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    P.__path__, 'vidgraph_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'vidgraph_tpu')]\n"
        "assert len(names) > 30, names\n"
        "assert not bad, bad\n"
        "print('imported', len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "VIDGRAPH_TORCH_DEVICE": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert "imported" in res.stdout


def test_cuda_asked_for_and_absent_raises(monkeypatch):
    import torch

    from vidgraph_tpu_torch.core import platform
    monkeypatch.setenv("VIDGRAPH_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="VIDGRAPH_TORCH_DEVICE"):
        platform.device()
    monkeypatch.setenv("VIDGRAPH_TORCH_DEVICE", "cpu")
    assert platform.device() == torch.device("cpu")


def test_acs_xla_backend_raises(built, monkeypatch):
    """``acs.backend: xla`` builds (it raised before the device sweep was
    ported) and a failure of the fused device sweep raises out of
    ``_compute`` (no fallback to another path); ``update_metrics`` turns it
    into the reference's ``error`` record."""
    _pkg, cfg, store, _d = built["port"]
    acs = tacs.ACSAutomata(store, tcfg.ACSConfig(backend="xla"))
    names, adj, _ = acs._build_arrays()

    def broken(*args, **kw):
        raise RuntimeError("device sweep failed")

    monkeypatch.setattr(tacs, "_acs_fused", broken)
    with pytest.raises(RuntimeError, match="device sweep failed"):
        acs._compute(names, adj, "xla")
    assert acs.update_metrics()["error"] == "device sweep failed"


def test_acs_metrics_under_auto_are_equal(built):
    """The shipped default, ``acs.backend: auto``: on the kg graph (above
    96 nodes, so both packages take their device sweep) every metric but
    the time is equal, Louvain's two included (the same masks, from JAX's
    stream)."""
    got = {}
    for name, (pkg, _cfg, store, _d) in built.items():
        m = pkg["acs"].ACSAutomata(store, pkg["cfg"].ACSConfig(
            backend="auto")).update_metrics()
        m.pop("computational_time")
        got[name] = m
    assert "error" not in got["port"]
    assert got["port"]["node_count"] >= tacs._AUTO_XLA_MIN_NODES
    assert got["port"] == got["jax"]
