"""Hybrid retrieval — the online latency path (p50 < 100 ms target).

Pipeline parity with reference src/pipeline/retriever_hybrid.py:142-282:

1. vector search on chunk embeddings (cosine > 0.3, top_k_chunks) — skipped
   when ``entity_first`` — in parallel with fulltext entity search;
2. graph traversal from the found entities (``graph_hops``), collecting
   entities, chunks and relationship descriptions;
3. post-compression (when enabled and not entity_first): chunks re-split
   256/32, segments scored against the query, kept above
   ``compression_threshold``, capped at top_k;
4. reranking — after traversal (entities/relationships/chunks separately,
   strict ``RerankerError`` mode) or after vector search;
5. formatting: ``Found results for '...':`` with Chunks / Related Entities /
   Related Relationships sections.

TPU-native redesign of the hot path: query embedding, chunk vector search,
and all compression-segment scoring happen as single batched device calls
through the fused cosine kernel — the reference made one HTTP round trip
per segment (N+1) plus Bolt round trips per stage.

Also implements the online scheduler: time-triggered queries during KG
construction with (query, time) dedupe and real-time append to the results
file (reference: src/pipeline/retriever_hybrid.py:53-140).
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.config import RetrievalConfig
from ..core.logger import get_logger
from ..services.rerank_client import RerankerError

logger = get_logger("hybrid_retriever")


def split_recursive(text: str, chunk_size: int = 256, overlap: int = 32,
                    separators: Tuple[str, ...] = ("\n\n", "\n", ". ", " "),
                    ) -> List[str]:
    """Character splitter with separator preference (compression re-split)."""
    if len(text) <= chunk_size:
        return [text] if text.strip() else []

    def _split(t: str, seps: Tuple[str, ...]) -> List[str]:
        if len(t) <= chunk_size:
            return [t]
        if not seps:
            step = max(1, chunk_size - overlap)
            return [t[i:i + chunk_size] for i in range(0, len(t), step)]
        sep, rest = seps[0], seps[1:]
        parts = t.split(sep) if sep in t else None
        if not parts or len(parts) == 1:
            return _split(t, rest)
        out: List[str] = []
        cur = ""
        for p in parts:
            candidate = (cur + sep + p) if cur else p
            if len(candidate) <= chunk_size:
                cur = candidate
            else:
                if cur:
                    out.append(cur)
                if len(p) > chunk_size:
                    out.extend(_split(p, rest))
                    cur = ""
                else:
                    cur = p
        if cur:
            out.append(cur)
        return out

    return [s for s in _split(text, separators) if s.strip()]


class HybridRetriever:
    def __init__(self, config: RetrievalConfig, graph_store, embed_client,
                 rerank_client=None,
                 schedule_path: Optional[str] = None,
                 output_file: Optional[str] = "retrieval_results.json",
                 ) -> None:
        self.config = config
        self.store = graph_store
        self.embed = embed_client
        self.reranker = rerank_client
        self.schedule_path = schedule_path
        self.retrieval_schedule = (self._load_retrieval_schedule()
                                   if schedule_path else [])
        self.executed_queries: List[Dict] = []
        self.executed_query_keys: set = set()
        self.output_file = Path(output_file) if output_file else None

    async def warm_cache(self) -> int:
        """Pre-embed every entity name and relationship description in one
        batched call so first-query latency equals steady-state (the rerank
        path otherwise pays the hash+project cost of each new text once)."""
        texts: List[str] = []
        try:
            texts.extend(self.store.entities.keys())
            for (h, typ, t) in getattr(self.store, "rels", {}):
                texts.append(f"{h} -[{typ}]-> {t}")
        except AttributeError:
            return 0
        if texts:
            await self.embed.aembed(texts)
        return len(texts)

    # --------------------------------------------------------------- schedule
    def _load_retrieval_schedule(self) -> List[Dict[str, str]]:
        try:
            with open(self.schedule_path) as f:
                data = json.load(f)
            return data.get("queries", data) if isinstance(data, dict) \
                else data
        except Exception as e:
            logger.error("Error loading retrieval schedule: %s", e)
            return []

    def _write_result_realtime(self, result: Dict) -> None:
        if not self.output_file:
            return
        try:
            existing = (json.loads(self.output_file.read_text())
                        if self.output_file.exists() else [])
            existing.append(result)
            self.output_file.write_text(json.dumps(existing, indent=2))
        except Exception as e:
            logger.error("Failed to write real-time result: %s", e)

    @staticmethod
    def parse_true_chunks(value) -> Optional[List[int]]:
        if not value:
            return None
        try:
            if isinstance(value, list):
                return [int(x) for x in value]
            if isinstance(value, str):
                parts = [p.strip() for p in value.strip("[]").split(",")
                         if p.strip()]
                return [int(x) for x in parts]
        except (ValueError, TypeError) as e:
            logger.debug("Could not parse true_chunks: %s", e)
        return None

    async def check_and_run_queries(self, current_video_time: str
                                    ) -> List[Dict]:
        """Run scheduled queries whose time has arrived (dedup on
        (query, time); schedule time <= batch end time)."""
        results = []
        for sched in self.retrieval_schedule:
            scheduled_time = sched.get("time", "")
            if "-" in current_video_time:
                end_time = current_video_time.split("-")[1].strip()
                matches = scheduled_time <= end_time
            else:
                end_time = current_video_time
                matches = scheduled_time == end_time
            if not matches:
                continue
            query = sched.get("query", "")
            key = (query, scheduled_time)
            if key in self.executed_query_keys:
                continue
            true_chunks = self.parse_true_chunks(
                sched.get("true_chunks") or sched.get("true_chunk"))
            logger.info("RETRIEVAL TRIGGERED at %s: %s", end_time, query)
            t0 = time.perf_counter()
            try:
                text, _ = await self.perform_hybrid_retrieval(query,
                                                              true_chunks)
                result = {
                    "time": current_video_time,
                    "query": query,
                    "groundtruth": sched.get("groundtruth", ""),
                    "retrieval": text,
                    "retrieval_time": time.perf_counter() - t0,
                }
                results.append(result)
                self.executed_queries.append(result)
                self.executed_query_keys.add(key)
                self._write_result_realtime(result)
            except Exception as e:
                logger.error("Error in retrieval: %s", e)
        return results

    # ------------------------------------------------------------- core flow
    async def perform_hybrid_retrieval(self, query: str,
                                       true_chunks: Optional[List[int]] = None
                                       ) -> Tuple[str, bool]:
        try:
            t_start = time.perf_counter()
            reranked = False

            # rerank_pool: over-fetch candidates so the reranker SELECTS
            # the final context rather than re-ordering a capped list
            pool = (self.config.rerank_pool
                    if (self.config.rerank_pool or 0) > 0
                    and self.config.use_reranker
                    and self.reranker is not None else 0)
            n_fetch = max(self.config.top_k_chunks, pool)

            # Step 1: vector + fulltext (vector skipped in entity_first mode)
            if self.config.entity_first:
                chunk_results: List[Dict] = []
                entity_results = self.store.fulltext_search_entities(
                    query, self.config.top_k_entities)
            else:
                qvec_task = self.embed.aembed_query(query)
                entity_results = self.store.fulltext_search_entities(
                    query, self.config.top_k_entities)
                qvec = await qvec_task
                chunk_results = self.store.vector_search_chunks(
                    qvec, n_fetch, threshold=0.3)

            if true_chunks:
                self._log_rankings(true_chunks, chunk_results,
                                   "initial vector search")

            # Step 2: graph traversal
            expanded, trav_chunks, trav_rels = \
                self.store.expand_entity_graph_with_chunks(
                    [e["name"] for e in entity_results],
                    self.config.graph_hops)

            # Step 3: post-compression
            if self.config.post_compression and chunk_results \
                    and not self.config.entity_first:
                chunk_results = await self._post_compress_chunks(
                    query, chunk_results)

            # Step 4: reranking
            if pool:
                # pooled mode: one rerank over the deduped combined set,
                # THEN the top_k_chunks cap — the reranker picks the
                # context (reference cross-encoder flow:
                # src/pipeline/retriever_hybrid.py:524-547)
                if self.config.rerank_after_traversal:
                    if self.config.rerank_entities and expanded:
                        expanded = await self._rerank(
                            query, expanded, "name", raise_on_failure=True)
                    if self.config.rerank_relationships and trav_rels:
                        trav_rels = await self._rerank(
                            query, trav_rels, "description",
                            raise_on_failure=True)
                combined, seen_ids = [], set()
                for c in (chunk_results or []) + (trav_chunks or []):
                    cid = c.get("id", id(c))
                    if cid not in seen_ids:
                        seen_ids.add(cid)
                        combined.append(c)
                if combined:
                    combined = await self._rerank(
                        query, combined, "content",
                        raise_on_failure=self.config.rerank_after_traversal)
                    reranked = True
                result_chunks = combined[:self.config.top_k_chunks]
            else:
                if self.config.rerank_after_traversal:
                    if self.config.rerank_entities and expanded:
                        expanded = await self._rerank(
                            query, expanded, "name", raise_on_failure=True)
                        reranked = True
                    if self.config.rerank_relationships and trav_rels:
                        trav_rels = await self._rerank(
                            query, trav_rels, "description",
                            raise_on_failure=True)
                        reranked = True
                    if trav_chunks:
                        trav_chunks = await self._rerank(
                            query, trav_chunks, "content",
                            raise_on_failure=True)
                        reranked = True
                elif self.config.use_reranker and chunk_results:
                    chunk_results = await self._rerank(query, chunk_results,
                                                       "content")
                    reranked = True

                result_chunks = ((chunk_results or []) + (trav_chunks or []))
                result_chunks = result_chunks[:self.config.top_k_chunks]

            if true_chunks:
                self._log_rankings(true_chunks, result_chunks,
                                   "final retrieval candidates")

            text = self._format_retrieval_results(query, result_chunks,
                                                  expanded, trav_rels)
            logger.debug("Total retrieval time: %.3fs",
                         time.perf_counter() - t_start)
            return text, reranked
        except RerankerError:
            raise
        except Exception as e:
            logger.error("Hybrid retrieval error: %s", e)
            return f"Retrieval failed: {e}", False

    # --------------------------------------------------------------- helpers
    @staticmethod
    def _log_rankings(true_chunks: List[int], chunks: List[Dict],
                      stage: str) -> None:
        rankings = {idx: None for idx in true_chunks}
        for pos, c in enumerate(chunks, start=1):
            try:
                parsed = int(str(c.get("id")).split("_")[-1])
            except (ValueError, TypeError):
                parsed = None
            if parsed is not None and parsed in rankings \
                    and rankings[parsed] is None:
                rankings[parsed] = pos
        for idx, pos in rankings.items():
            if pos is not None:
                logger.info("True chunk %d found in %s at rank: %d",
                            idx, stage, pos)
            else:
                logger.info("True chunk %d NOT found in %s", idx, stage)

    async def _post_compress_chunks(self, query: str, chunks: List[Dict]
                                    ) -> List[Dict]:
        """Split chunks into segments, keep segments similar to the query.

        All segments are embedded in ONE batched device call and scored with
        one fused matmul (the reference embedded each segment over HTTP)."""
        if not chunks:
            return chunks
        try:
            segments: List[str] = []
            owners: List[Dict] = []
            for chunk in chunks:
                for seg in split_recursive(chunk["content"], 256, 32):
                    segments.append(seg)
                    owners.append(chunk)
            if not segments:
                return chunks
            vecs = await self.embed.aembed([query] + segments)
            q, segs = vecs[0], vecs[1:]
            qn = q / (np.linalg.norm(q) + 1e-12)
            sn = segs / (np.linalg.norm(segs, axis=1, keepdims=True) + 1e-12)
            sims = sn @ qn
            out = []
            for chunk, seg, sim in zip(owners, segments, sims):
                if sim >= self.config.compression_threshold:
                    out.append({**chunk, "content": seg,
                                "compression_score": float(sim)})
            out.sort(key=lambda c: -c["compression_score"])
            logger.debug("Post-compression retained %d/%d segments",
                         len(out), len(segments))
            return out[:self.config.top_k]
        except Exception as e:
            logger.warning("Post-compression failed: %s", e)
            return chunks

    async def _rerank(self, query: str, items: List[Dict], field: str,
                      raise_on_failure: bool = False) -> List[Dict]:
        if not self.config.use_reranker or not items or \
                self.reranker is None:
            return items
        try:
            docs = [it[field] for it in items]
            order = await self.reranker.rerank(query, docs, len(docs))
            return [items[i] for i, _score in order if i < len(items)]
        except Exception as e:
            if raise_on_failure:
                logger.error("Reranking (%s) failed in strict mode: %s",
                             field, e)
                raise RerankerError(str(e))
            logger.warning("Reranking failed: %s", e)
            return items

    def _format_retrieval_results(self, query: str, chunks: List[Dict],
                                  entities: List[Dict],
                                  relationships: Optional[List[Dict]] = None,
                                  ) -> str:
        parts: List[str] = []
        if chunks:
            parts.append(f"Chunks ({len(chunks)}):")
            for i, chunk in enumerate(chunks, 1):
                score = (f" (score: {chunk.get('score', 0):.3f})"
                         if "score" in chunk else "")
                t = (f" [time: {chunk.get('time', '')}]"
                     if chunk.get("time") else "")
                parts.append(f"  {i}. {chunk['content']}{score}{t}")
        if entities:
            parts.append(f"\nRelated Entities ({len(entities)}):")
            for i, ent in enumerate(
                    entities[:self.config.top_k_entities], 1):
                score = (f" (score: {ent.get('score', 0):.3f})"
                         if "score" in ent else "")
                parts.append(f"  {i}. {ent['name']}{score}")
        if relationships:
            parts.append(
                f"\nRelated Relationships ({len(relationships)}):")
            for i, rel in enumerate(
                    relationships[:self.config.top_k_relationships], 1):
                parts.append(f"  {i}. {rel['description']}")
        if not parts:
            return f"No results found for query '{query}'"
        return f"Found results for '{query}':\n" + "\n".join(parts)

    async def close(self) -> None:
        logger.info("Closing hybrid retriever")
