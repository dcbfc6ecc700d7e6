from typing import Optional

from .base import GraphStore
from .embedded import EmbeddedGraphStore, rel_label
from .exporter import GraphExporter, GraphImporter


def open_graph_store(config, graph_uuid: str,
                     load_existing: bool = True) -> GraphStore:
    """Open the configured graph-store backend for a run UUID."""
    gs = config.graph_store
    if gs.backend == "embedded":
        return EmbeddedGraphStore(
            graph_uuid,
            persist_dir=gs.persist_dir if gs.persist else None,
            persist=gs.persist,
            dim=config.embedding_memory.dim,
            load_existing=load_existing,
            # LM chat backends emit near-miss op names; ground them via
            # the store's resolution ladder.  The deterministic local
            # client emits exact names — keep reference exact-match
            # semantics there (embedded.py::_resolve_entity).
            resolve_op_names=getattr(config.backend, "llm", "local")
            != "local",
        )
    if gs.backend == "neo4j":
        from .neo4j_backend import Neo4jGraphStore
        return Neo4jGraphStore(graph_uuid, config.neo4j)
    raise ValueError(f"unknown graph_store backend: {gs.backend}")


__all__ = ["GraphStore", "EmbeddedGraphStore", "GraphExporter",
           "GraphImporter", "open_graph_store", "rel_label"]
