"""The port's Neo4j graph store on the in-memory fake driver
(``tests/fake_neo4j.py``), as ``tests/test_neo4j_backend.py`` tests the
JAX package's: every behavioural check of that file runs on the port's
store, and the same operations on both packages' stores issue the same
Cypher and leave the same graph."""
import os

os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"

import pytest  # noqa: E402

import test_neo4j_backend as jax_cases  # noqa: E402
from fake_neo4j import install  # noqa: E402

CHECKS = ["check_merge_idempotent", "check_source_chunk_ids",
          "check_merge_applies", "check_prune", "check_inter_chunk",
          "check_vector_search", "check_fulltext_search", "check_traversal",
          "check_accessors"]


def make_store(monkeypatch, uuid="test-uuid", **kw):
    drv = install(monkeypatch, **kw)
    from vidgraph_tpu_torch.core.config import Neo4jConfig
    from vidgraph_tpu_torch.graph.neo4j_backend import Neo4jGraphStore

    return Neo4jGraphStore(uuid, Neo4jConfig()), drv


@pytest.mark.parametrize("check", CHECKS)
def test_behavioural_check_on_the_port(monkeypatch, check):
    store, _ = make_store(monkeypatch, supports_apoc=False)
    getattr(jax_cases, check)(store)


@pytest.mark.parametrize("apoc,fail_manual,existing", [
    (True, False, "Beaker"), (False, False, "Balance"),
    (False, True, "Balance")])
def test_merge_ladder_on_the_port(monkeypatch, apoc, fail_manual, existing):
    """APOC, the manual transfer and the force-delete rung."""
    store, drv = make_store(monkeypatch, supports_apoc=apoc,
                            fail_manual_merge=fail_manual)
    jax_cases._batch(store, jax_cases.TRIPLETS, jax_cases.CHUNKS)
    ops = {"merge_instructions": [{"local": "Person",
                                   "existing": existing}]}
    jax_cases._batch(store, [], None, operations=ops, batch_idx=1)
    assert store.get_entity("Person") is None
    target = store.get_entity(existing)
    assert target is not None
    if apoc:
        assert not any("UNION ALL" in q for q, _ in drv.graph.queries)
    elif not fail_manual:
        assert target.get("merged_from") == ["Person"]
        assert any(h == existing and t == "Beaker" and typ == "HOLDS"
                   for h, typ, t, _ in store.relations_of_entity(existing))


def test_export_import_roundtrip_on_the_port(monkeypatch):
    from vidgraph_tpu_torch.core.config import Neo4jConfig
    from vidgraph_tpu_torch.graph.neo4j_backend import Neo4jGraphStore

    store, drv = make_store(monkeypatch)
    store2 = Neo4jGraphStore("other-uuid", Neo4jConfig())
    store2._driver = drv
    jax_cases.check_export_import(store, store2)


def _session(monkeypatch, pkg):
    """One run of every write path and a few reads on a fresh fake
    database: (the Cypher issued, the export without its timestamp, the
    reads)."""
    drv = install(monkeypatch, supports_apoc=False)
    if pkg == "jax":
        from vidgraph_tpu.core.config import Neo4jConfig
        from vidgraph_tpu.graph.neo4j_backend import Neo4jGraphStore
    else:
        from vidgraph_tpu_torch.core.config import Neo4jConfig
        from vidgraph_tpu_torch.graph.neo4j_backend import Neo4jGraphStore
    store = Neo4jGraphStore("test-uuid", Neo4jConfig())
    jax_cases._batch(store, jax_cases.TRIPLETS, jax_cases.CHUNKS)
    jax_cases._batch(store, [], None, batch_idx=1, operations={
        "merge_instructions": [{"local": "Person", "existing": "Balance"}],
        "inter_chunk_relations": [["Balance", "observes", "Beaker",
                                   ["u_0_1"]]]})
    export = store.export_data()
    export.pop("export_timestamp")
    reads = {"vector": store.vector_search_chunks([1.0, 0.05, 0.0], top_k=2,
                                                  threshold=0.3),
             "fulltext": store.fulltext_search_entities("beaker", top_k=5),
             "expand": store.expand_entity_graph_with_chunks(["Balance"],
                                                             hops=2),
             "counts": (store.get_node_count(),
                        store.get_relationship_count())}
    return [q for q, _ in drv.graph.queries], export, reads


def test_same_cypher_and_graph_as_jax(monkeypatch):
    jq, jexp, jreads = _session(monkeypatch, "jax")
    tq, texp, treads = _session(monkeypatch, "torch")
    assert tq == jq and len(tq) > 10
    assert texp == jexp
    assert repr(treads) == repr(jreads)


def test_open_graph_store_takes_the_neo4j_branch(monkeypatch):
    from vidgraph_tpu_torch.core.config import PipelineConfig
    from vidgraph_tpu_torch.graph import open_graph_store
    from vidgraph_tpu_torch.graph.neo4j_backend import Neo4jGraphStore

    install(monkeypatch)
    cfg = PipelineConfig()
    cfg.graph_store.backend = "neo4j"
    store = open_graph_store(cfg, "cfg-uuid")
    assert isinstance(store, Neo4jGraphStore)
    assert store.verify_connection()
