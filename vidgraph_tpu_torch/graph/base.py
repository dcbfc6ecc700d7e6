"""Abstract graph-store interface.

Mirrors the public surface of the reference's Neo4jHandler (reference:
src/components/neo4j_handler.py:13-746) so pipeline components are
backend-agnostic: the default backend is the in-process EmbeddedGraphStore
(no external services), and a Bolt/Neo4j backend can be plugged in where a
server is available.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, List, Optional, Sequence, Tuple


class GraphStore(abc.ABC):
    graph_uuid: str

    # -- lifecycle ----------------------------------------------------------
    @abc.abstractmethod
    def verify_connection(self) -> bool: ...

    @abc.abstractmethod
    def create_indexes(self) -> None: ...

    @abc.abstractmethod
    def close(self) -> None: ...

    # -- writes --------------------------------------------------------------
    @abc.abstractmethod
    def add_batch_to_graph(self, triplets: List[Dict[str, Any]],
                           batch_data: List[Dict[str, Any]],
                           batch_idx: int = 0,
                           text_chunks: Optional[List[Dict[str, Any]]] = None,
                           operations: Optional[Dict[str, Any]] = None,
                           ) -> Dict[str, float]: ...

    # -- counts ---------------------------------------------------------------
    @abc.abstractmethod
    def get_node_count(self) -> int: ...

    @abc.abstractmethod
    def get_relationship_count(self) -> int: ...

    @abc.abstractmethod
    def get_chunk_counts(self) -> Dict[str, int]: ...

    # -- retrieval primitives --------------------------------------------------
    @abc.abstractmethod
    def vector_search_chunks(self, query_embedding, top_k: int,
                             threshold: float = 0.3,
                             ) -> List[Dict[str, Any]]: ...

    @abc.abstractmethod
    def fulltext_search_entities(self, query: str, top_k: int,
                                 ) -> List[Dict[str, Any]]: ...

    @abc.abstractmethod
    def expand_entity_graph_with_chunks(
        self, entity_names: Sequence[str], hops: int,
    ) -> Tuple[List[Dict], List[Dict], List[Dict]]: ...

    @abc.abstractmethod
    def get_chunk_embeddings(self, limit: int = 5000,
                             ) -> Tuple[List[str], Any]: ...

    def similarity_to_chunks(self, vectors) -> Tuple[List[str], Any]:
        """(chunk_ids, [nq, n_chunks] cosine scores). Default: numpy over
        get_chunk_embeddings; backends override with a device path."""
        import numpy as np

        ids, existing = self.get_chunk_embeddings()
        q = np.atleast_2d(np.asarray(vectors, np.float32))
        if not ids:
            return [], np.zeros((q.shape[0], 0), np.float32)
        qn = q / (np.linalg.norm(q, axis=1, keepdims=True) + 1e-12)
        en = existing / (np.linalg.norm(existing, axis=1, keepdims=True)
                         + 1e-12)
        return ids, qn @ en.T

    # -- subgraph context (for pre-injection similarity path) -----------------
    @abc.abstractmethod
    def get_chunk(self, chunk_id: str) -> Optional[Dict[str, Any]]: ...

    @abc.abstractmethod
    def entities_of_chunk(self, chunk_id: str) -> List[str]: ...

    @abc.abstractmethod
    def get_entity(self, name: str) -> Optional[Dict[str, Any]]: ...

    @abc.abstractmethod
    def entities_with_source_chunk(self, chunk_id: str) -> List[str]:
        """Entity names whose ``source_chunk_ids`` contains ``chunk_id``
        (the seed set for subgraph-context extraction)."""
        ...

    @abc.abstractmethod
    def relations_of_entity(self, name: str,
                            ) -> List[Tuple[str, str, str, Dict]]: ...

    # -- export/import ----------------------------------------------------------
    @abc.abstractmethod
    def export_data(self) -> Dict[str, Any]: ...

    @abc.abstractmethod
    def import_data(self, data: Dict[str, Any]) -> None: ...
