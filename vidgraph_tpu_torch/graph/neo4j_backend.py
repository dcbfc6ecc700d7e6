"""Neo4j (Bolt) graph-store backend — optional, requires the ``neo4j``
driver (``pip install vidgraph-tpu[neo4j]``).

Preserves the reference's Cypher semantics (reference:
src/components/neo4j_handler.py): ``:Entity:GraphNode`` / ``:Chunk:GraphNode``
labels, ``graph_uuid`` isolation property, dynamic relationship types,
constraints + the ``entityName`` fulltext index, APOC merge with manual
fallback, and vector search via ``vector.similarity.cosine``.

This backend exists for deployments that need a shared external graph
database; the embedded store is the default and the only backend exercised
by this repository's test environment (no Bolt service available).
"""
from __future__ import annotations

import datetime as _dt
from typing import Any, Dict, List, Optional

from ..core.config import Neo4jConfig
from ..core.logger import get_logger
from .base import GraphStore
from .embedded import rel_label

logger = get_logger("neo4j_store")


class Neo4jGraphStore(GraphStore):
    def __init__(self, graph_uuid: str, config: Neo4jConfig) -> None:
        try:
            from neo4j import GraphDatabase
        except ImportError as e:  # pragma: no cover - driver not in test env
            raise ImportError(
                "neo4j backend requested but the 'neo4j' driver is not "
                "installed; use graph_store.backend=embedded or install "
                "vidgraph-tpu[neo4j]") from e
        self.graph_uuid = graph_uuid
        self.config = config
        self._driver = GraphDatabase.driver(
            config.uri, auth=(config.user, config.password))
        self._db = config.database

    def _run(self, query: str, **params):
        with self._driver.session(database=self._db) as session:
            return list(session.run(query, **params))

    # ----------------------------------------------------------- lifecycle
    def verify_connection(self) -> bool:
        try:
            self._run("RETURN 1")
            return True
        except Exception as e:
            logger.error("Neo4j connection failed: %s", e)
            return False

    def create_indexes(self) -> None:
        statements = [
            "CREATE CONSTRAINT entity_name_uuid IF NOT EXISTS "
            "FOR (e:Entity) REQUIRE (e.name, e.graph_uuid) IS UNIQUE",
            "CREATE CONSTRAINT chunk_id_uuid IF NOT EXISTS "
            "FOR (c:Chunk) REQUIRE (c.id, c.graph_uuid) IS UNIQUE",
            "CREATE FULLTEXT INDEX entityName IF NOT EXISTS "
            "FOR (e:Entity) ON EACH [e.name]",
        ]
        for stmt in statements:
            try:
                self._run(stmt)
            except Exception as e:
                logger.warning("Index creation warning: %s", e)

    def close(self) -> None:
        self._driver.close()

    # ---------------------------------------------------------------- writes
    def add_batch_to_graph(self, triplets, batch_data, batch_idx=0,
                           text_chunks=None, operations=None,
                           ) -> Dict[str, float]:
        import time as _time

        t0 = _time.perf_counter()
        batch_time = batch_data[-1].get("time", "") if batch_data else ""
        for tr in triplets or []:
            head = (tr.get("head") or "").strip()
            relation = (tr.get("relation") or "").strip()
            tail = (tr.get("tail") or "").strip()
            if not head or not relation or not tail:
                continue
            sources = tr.get("source_chunks", [])
            for name in (head, tail):
                self._run(
                    "MERGE (e:Entity:GraphNode {name: $name, "
                    "graph_uuid: $uuid}) "
                    "SET e.created_at = coalesce(e.created_at, datetime()), "
                    "e.batch_time = $bt, e.batch_id = $bi, "
                    "e.source_chunks = $sc",
                    name=name, uuid=self.graph_uuid, bt=batch_time,
                    bi=batch_idx, sc=sources)
            self._run(
                f"MATCH (h:Entity {{name: $h, graph_uuid: $uuid}}) "
                f"MATCH (t:Entity {{name: $t, graph_uuid: $uuid}}) "
                f"MERGE (h)-[r:`{rel_label(relation)}` "
                f"{{graph_uuid: $uuid}}]->(t) "
                f"SET r.source_chunks = $sc, r.batch_id = $bi",
                h=head, t=tail, uuid=self.graph_uuid, sc=sources,
                bi=batch_idx)
        for chunk in text_chunks or []:
            self._run(
                "MERGE (c:Chunk:GraphNode {id: $id, graph_uuid: $uuid}) "
                "SET c.content = $content, c.embedding = $emb, "
                "c.created_at = coalesce(c.created_at, datetime()), "
                "c.batch_id = $bi, c.time = $time",
                id=chunk["id"], uuid=self.graph_uuid,
                content=chunk.get("content", ""),
                emb=chunk.get("embedding"), bi=batch_idx,
                time=chunk.get("time"))
            for tr in triplets or []:
                from .embedded import EmbeddedGraphStore
                if not EmbeddedGraphStore._chunk_matches_sources(
                        chunk["id"], chunk.get("index"),
                        tr.get("source_chunks")):
                    continue
                for ent in (tr.get("head"), tr.get("tail")):
                    if ent:
                        self._run(
                            "MATCH (e:Entity {name: $e, graph_uuid: $uuid}) "
                            "MATCH (c:Chunk {id: $c, graph_uuid: $uuid}) "
                            "MERGE (e)-[:FROM_CHUNK]->(c)",
                            e=ent.strip(), c=chunk["id"],
                            uuid=self.graph_uuid)
        self._run(
            "MATCH (e:Entity:GraphNode)-[:FROM_CHUNK]->(c:Chunk:GraphNode) "
            "WHERE e.graph_uuid = $uuid AND c.graph_uuid = $uuid "
            "AND c.batch_id = $bi "
            "WITH e, collect(DISTINCT c.id) AS ids "
            "SET e.source_chunk_ids = coalesce(e.source_chunk_ids, []) + ids",
            uuid=self.graph_uuid, bi=batch_idx)
        counts = {}
        if operations:
            self._apply_operations(operations, batch_idx)
            counts = {
                "ops_emitted_merge":
                    len(operations.get("merge_instructions") or []),
                "ops_emitted_prune":
                    len(operations.get("prune_instructions") or []),
                "ops_emitted_inter":
                    len(operations.get("inter_chunk_relations") or [])}
        self.create_indexes()
        return {"embedding_time": 0.0, "indexing_time": 0.0,
                "graph_injection_time": _time.perf_counter() - t0,
                **counts}

    def _apply_operations(self, operations, batch_idx):
        for m in operations.get("merge_instructions") or []:
            local, existing = m.get("local"), m.get("existing")
            if not local or not existing or local == existing:
                continue
            self._merge_entities(local, existing)
        for p in operations.get("prune_instructions") or []:
            try:
                if "entity" in p and p.get("entity"):
                    self._run(
                        "MATCH (n:Entity:GraphNode {name: $n, "
                        "graph_uuid: $u}) DETACH DELETE n",
                        n=p["entity"], u=self.graph_uuid)
                elif {"head", "relation", "tail"} <= set(p):
                    self._run(
                        f"MATCH (h:Entity:GraphNode {{name: $h, "
                        f"graph_uuid: $u}})-[r:`{rel_label(p['relation'])}`]"
                        f"-(t:Entity:GraphNode {{name: $t, "
                        f"graph_uuid: $u}}) DELETE r",
                        h=p["head"], t=p["tail"], u=self.graph_uuid)
            except Exception as e:
                logger.warning("Prune failed %s: %s", p, e)
        for it in operations.get("inter_chunk_relations") or []:
            if len(it) < 3:
                continue
            sources = it[3] if len(it) > 3 and isinstance(it[3], list) else []
            try:
                self._run(
                    f"MATCH (h:Entity:GraphNode {{name: $h, "
                    f"graph_uuid: $u}}) "
                    f"MATCH (t:Entity:GraphNode {{name: $t, "
                    f"graph_uuid: $u}}) "
                    f"MERGE (h)-[r:`{rel_label(it[1])}` "
                    f"{{graph_uuid: $u}}]->(t) "
                    f"SET r.source_chunks = coalesce(r.source_chunks, []) "
                    f"+ $sc, r.batch_id = $bi",
                    h=it[0], t=it[2], u=self.graph_uuid, sc=sources,
                    bi=batch_idx)
            except Exception as e:
                logger.warning("Inter-chunk relation failed %s: %s", it, e)
        self._run(
            "MATCH (n:Entity:GraphNode) WHERE n.graph_uuid = $u "
            "AND NOT (n)--() DETACH DELETE n", u=self.graph_uuid)

    def _merge_entities(self, local: str, existing: str) -> None:
        """Three-rung merge ladder, mirroring the reference
        (src/components/neo4j_handler.py:474-566): APOC refactor merge ->
        manual relationship/property transfer -> force-delete of the local
        node so a failed merge can never leave a duplicate behind."""
        try:
            self._run(
                "MATCH (l:Entity:GraphNode {name: $l, graph_uuid: $u}) "
                "MATCH (e:Entity:GraphNode {name: $e, graph_uuid: $u}) "
                "CALL apoc.refactor.mergeNodes([e, l], "
                "{properties: 'combine'}) YIELD node "
                "SET node.name = $e RETURN node",
                l=local, e=existing, u=self.graph_uuid)
            return
        except Exception as err:
            logger.warning("APOC merge failed (%s -> %s): %s — trying "
                           "manual transfer", local, existing, err)
        try:
            # Transfer relationships one dynamic type at a time (Cypher
            # cannot MERGE a dynamic relationship type without APOC).
            rows = self._run(
                "MATCH (l:Entity:GraphNode {name: $l, graph_uuid: $u})"
                "-[r]->(t:GraphNode) "
                "RETURN type(r) AS t, coalesce(t.name, t.id) AS other, "
                "properties(r) AS p, true AS out "
                "UNION ALL "
                "MATCH (s:GraphNode)-[r]->"
                "(l:Entity:GraphNode {name: $l, graph_uuid: $u}) "
                "RETURN type(r) AS t, coalesce(s.name, s.id) AS other, "
                "properties(r) AS p, false AS out",
                l=local, u=self.graph_uuid)
            for r in rows:
                props = {k: v for k, v in dict(r["p"]).items()
                         if k != "graph_uuid"}
                if r["out"]:
                    pat = (f"MATCH (e:Entity:GraphNode {{name: $e, "
                           f"graph_uuid: $u}}) "
                           f"MATCH (o:GraphNode {{graph_uuid: $u}}) "
                           f"WHERE o.name = $o OR o.id = $o "
                           f"MERGE (e)-[nr:`{rel_label(r['t'])}`]->(o) "
                           f"SET nr += $p, nr.graph_uuid = $u")
                else:
                    pat = (f"MATCH (e:Entity:GraphNode {{name: $e, "
                           f"graph_uuid: $u}}) "
                           f"MATCH (o:GraphNode {{graph_uuid: $u}}) "
                           f"WHERE o.name = $o OR o.id = $o "
                           f"MERGE (o)-[nr:`{rel_label(r['t'])}`]->(e) "
                           f"SET nr += $p, nr.graph_uuid = $u")
                self._run(pat, e=existing, o=r["other"], u=self.graph_uuid,
                          p=props)
            # combine scalar props + source_chunk_ids, then drop the local
            self._run(
                "MATCH (l:Entity:GraphNode {name: $l, graph_uuid: $u}) "
                "MATCH (e:Entity:GraphNode {name: $e, graph_uuid: $u}) "
                "SET e.source_chunk_ids = coalesce(e.source_chunk_ids, []) "
                "+ coalesce(l.source_chunk_ids, []), "
                "e.merged_from = coalesce(e.merged_from, []) + $l "
                "DETACH DELETE l",
                l=local, e=existing, u=self.graph_uuid)
            return
        except Exception as err:
            logger.warning("Manual merge failed (%s -> %s): %s — "
                           "force-deleting local", local, existing, err)
        try:
            self._run(
                "MATCH (l:Entity:GraphNode {name: $l, graph_uuid: $u}) "
                "DETACH DELETE l", l=local, u=self.graph_uuid)
        except Exception as err:
            logger.error("Force-delete failed for %s: %s", local, err)

    # --------------------------------------------------------------- counts
    def get_node_count(self) -> int:
        rec = self._run("MATCH (n:GraphNode) WHERE n.graph_uuid = $u "
                        "RETURN count(n) AS c", u=self.graph_uuid)
        return rec[0]["c"] if rec else 0

    def get_relationship_count(self) -> int:
        rec = self._run("MATCH ()-[r]->() WHERE r.graph_uuid = $u "
                        "RETURN count(r) AS c", u=self.graph_uuid)
        return rec[0]["c"] if rec else 0

    def get_chunk_counts(self) -> Dict[str, int]:
        total = self._run("MATCH (c:Chunk:GraphNode) WHERE c.graph_uuid=$u "
                          "RETURN count(c) AS c", u=self.graph_uuid)
        emb = self._run("MATCH (c:Chunk:GraphNode) WHERE c.graph_uuid=$u "
                        "AND c.embedding IS NOT NULL RETURN count(c) AS c",
                        u=self.graph_uuid)
        linked = self._run(
            "MATCH (c:Chunk:GraphNode)<-[:FROM_CHUNK]-(:Entity) "
            "WHERE c.graph_uuid=$u RETURN count(DISTINCT c) AS c",
            u=self.graph_uuid)
        return {"total_chunks": total[0]["c"] if total else 0,
                "with_embedding": emb[0]["c"] if emb else 0,
                "linked_chunks": linked[0]["c"] if linked else 0}

    # -------------------------------------------------------------- retrieval
    def vector_search_chunks(self, query_embedding, top_k: int,
                             threshold: float = 0.3) -> List[Dict[str, Any]]:
        rows = self._run(
            "MATCH (c:Chunk {graph_uuid: $u}) "
            "WHERE c.embedding IS NOT NULL "
            "WITH c, vector.similarity.cosine(c.embedding, $q) AS sim "
            "WHERE sim > $thr "
            "RETURN c.id AS id, c.time AS time, c.content AS content, "
            "sim AS score ORDER BY score DESC LIMIT $k",
            u=self.graph_uuid, q=[float(x) for x in query_embedding],
            thr=threshold, k=top_k)
        return [{"id": r["id"], "time": r["time"], "content": r["content"],
                 "score": float(r["score"]), "source": "vector"}
                for r in rows]

    def fulltext_search_entities(self, query: str, top_k: int,
                                 ) -> List[Dict[str, Any]]:
        try:
            rows = self._run(
                'CALL db.index.fulltext.queryNodes("entityName", $q) '
                "YIELD node, score WHERE node.graph_uuid = $u "
                "RETURN node.name AS name, node.batch_time AS bt, score "
                "ORDER BY score DESC LIMIT $k",
                q=query, u=self.graph_uuid, k=top_k)
        except Exception as e:
            logger.warning("Fulltext search failed: %s", e)
            return []
        return [{"name": r["name"], "batch_time": r["bt"] or "",
                 "score": float(r["score"]), "source": "fulltext"}
                for r in rows]

    def expand_entity_graph_with_chunks(self, entity_names, hops):
        ents, chunks, rels = set(), set(), set()
        for name in entity_names:
            rows = self._run(
                f"MATCH (e:Entity {{name: $n, graph_uuid: $u}}) "
                f"MATCH path = (e)-[*1..{int(hops)}]-(related) "
                f"WHERE related.graph_uuid = $u "
                f"UNWIND relationships(path) AS rel "
                f"RETURN DISTINCT related.name AS name, related.id AS id, "
                f"related.batch_time AS bt, related.content AS content, "
                f"related.time AS time, labels(related) AS labels, "
                f"type(rel) AS rt, startNode(rel).name AS sn, "
                f"endNode(rel).name AS en",
                n=name, u=self.graph_uuid)
            for r in rows:
                if "Entity" in r["labels"]:
                    ents.add((r["name"], r["bt"] or ""))
                elif "Chunk" in r["labels"]:
                    chunks.add((r["id"], r["content"], r["time"]))
                rels.add(f"{r['sn']} -[{r['rt']}]-> {r['en']}")
        return ([{"name": n, "batch_time": t, "source": "graph_traversal"}
                 for n, t in ents],
                [{"id": i, "content": c, "time": t,
                  "source": "graph_traversal"} for i, c, t in chunks],
                [{"description": d, "source": "graph_traversal"}
                 for d in sorted(rels)])

    def get_chunk_embeddings(self, limit: int = 5000):
        import numpy as np

        rows = self._run(
            "MATCH (c:Chunk:GraphNode) WHERE c.graph_uuid = $u "
            "AND c.embedding IS NOT NULL "
            "RETURN c.id AS id, c.embedding AS emb LIMIT $l",
            u=self.graph_uuid, l=limit)
        ids = [r["id"] for r in rows]
        vecs = (np.asarray([r["emb"] for r in rows], np.float32)
                if rows else np.zeros((0, 0), np.float32))
        return ids, vecs

    # ------------------------------------------------------ subgraph context
    def get_chunk(self, chunk_id: str) -> Optional[Dict[str, Any]]:
        rows = self._run("MATCH (c:Chunk {id: $id, graph_uuid: $u}) "
                         "RETURN properties(c) AS p", id=chunk_id,
                         u=self.graph_uuid)
        return dict(rows[0]["p"]) if rows else None

    def entities_of_chunk(self, chunk_id: str) -> List[str]:
        rows = self._run(
            "MATCH (e:Entity)-[:FROM_CHUNK]->(c:Chunk {id: $id, "
            "graph_uuid: $u}) RETURN e.name AS n ORDER BY n",
            id=chunk_id, u=self.graph_uuid)
        return [r["n"] for r in rows]

    def get_entity(self, name: str) -> Optional[Dict[str, Any]]:
        rows = self._run("MATCH (e:Entity {name: $n, graph_uuid: $u}) "
                         "RETURN properties(e) AS p", n=name,
                         u=self.graph_uuid)
        return dict(rows[0]["p"]) if rows else None

    def entities_with_source_chunk(self, chunk_id: str) -> List[str]:
        rows = self._run(
            "MATCH (e:Entity:GraphNode) WHERE e.graph_uuid = $u "
            "AND $c IN coalesce(e.source_chunk_ids, []) "
            "RETURN e.name AS n", c=chunk_id, u=self.graph_uuid)
        return [r["n"] for r in rows]

    def relations_of_entity(self, name: str):
        rows = self._run(
            "MATCH (h:Entity {graph_uuid: $u})-[r]->(t:Entity "
            "{graph_uuid: $u}) WHERE h.name = $n OR t.name = $n "
            "RETURN h.name AS h, type(r) AS typ, t.name AS t, "
            "properties(r) AS p", n=name, u=self.graph_uuid)
        return [(r["h"], r["typ"], r["t"], dict(r["p"])) for r in rows]

    # ------------------------------------------------------------- export/import
    def export_data(self) -> Dict[str, Any]:
        nodes = []
        for r in self._run(
                "MATCH (n:GraphNode) WHERE n.graph_uuid = $u "
                "RETURN n.name AS name, labels(n) AS labels, "
                "properties(n) AS props", u=self.graph_uuid):
            props = {k: v for k, v in dict(r["props"]).items()
                     if k != "graph_uuid"}
            nodes.append({"name": r["name"],
                          "labels": [l for l in r["labels"]
                                     if l != "GraphNode"],
                          "properties": props})
        rels = []
        for r in self._run(
                "MATCH (a:GraphNode)-[rel]->(b:GraphNode) "
                "WHERE a.graph_uuid = $u AND b.graph_uuid = $u "
                "RETURN type(rel) AS t, a.name AS f, "
                "coalesce(b.name, b.id) AS to, properties(rel) AS p",
                u=self.graph_uuid):
            props = {k: v for k, v in dict(r["p"]).items()
                     if k != "graph_uuid"}
            rels.append({"type": r["t"], "from_node": r["f"],
                         "to_node": r["to"], "properties": props})
        return {"graph_uuid": self.graph_uuid,
                "export_timestamp":
                    _dt.datetime.now(_dt.timezone.utc).isoformat(),
                "nodes": nodes, "relationships": rels,
                "export_format_version": "1.0"}

    def import_data(self, data: Dict[str, Any]) -> None:
        for node in data.get("nodes", []):
            labels = [l for l in node.get("labels", []) if l] + ["GraphNode"]
            props = dict(node.get("properties", {}))
            props["graph_uuid"] = self.graph_uuid
            if "Chunk" in labels:
                key, val = "id", props.get("id")
            else:
                key, val = "name", node.get("name") or props.get("name")
            if not val:
                continue
            label_str = ":".join(f"`{l}`" for l in labels)
            self._run(
                f"MERGE (n:{label_str} {{{key}: $v, graph_uuid: $u}}) "
                f"SET n += $props", v=val, u=self.graph_uuid, props=props)
        for rel in data.get("relationships", []):
            t = rel.get("to_node")
            if not t:
                continue
            props = dict(rel.get("properties", {}))
            props["graph_uuid"] = self.graph_uuid
            self._run(
                f"MATCH (a:GraphNode {{graph_uuid: $u}}) "
                f"WHERE a.name = $f OR a.id = $f "
                f"MATCH (b:GraphNode {{graph_uuid: $u}}) "
                f"WHERE b.name = $t OR b.id = $t "
                f"MERGE (a)-[r:`{rel['type']}`]->(b) SET r += $props",
                f=rel["from_node"], t=t, u=self.graph_uuid, props=props)
