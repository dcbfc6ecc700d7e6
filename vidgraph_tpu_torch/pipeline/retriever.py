"""Offline / online retriever wrappers (reference:
src/pipeline/retriever.py:13-387).

``OfflineRetriever`` opens the persisted graph for a run UUID, answers one
query or a batch file through the hybrid retrieval flow, and emits records
``{query, groundtruth, retrieval, graph_uuid, retrieval_time, verbose}``.
``OnlineRetriever`` is the legacy fulltext-only online path kept for surface
parity (KG builds use HybridRetriever's scheduler).
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..core.config import PipelineConfig
from ..core.logger import get_logger
from ..graph import open_graph_store
from ..services.embed_client import make_embed_client
from ..services.rerank_client import RerankerError, make_rerank_client
from .retriever_hybrid import HybridRetriever

logger = get_logger("retriever")


class OfflineRetriever:
    def __init__(self, config: PipelineConfig, graph_uuid: str,
                 graph_store=None, embed_client=None,
                 rerank_client=None) -> None:
        self.config = config
        self.graph_uuid = graph_uuid
        self.store = graph_store if graph_store is not None else \
            open_graph_store(config, graph_uuid)
        self.embed = embed_client or make_embed_client(
            config.backend.embedder, dim=config.embedding_memory.dim,
            endpoint=config.embedder.endpoint, model=config.embedder.model,
            api_key=config.embedder.api_key,
            checkpoint_path=config.embedder.checkpoint_path)
        self.rerank = rerank_client
        if self.rerank is None and config.retrieval.use_reranker:
            self.rerank = make_rerank_client(
                config.backend.reranker, embed_client=self.embed,
                endpoint=config.retrieval.reranker_endpoint,
                model=config.retrieval.reranker_model,
                api_key=config.retrieval.reranker_api_key,
                checkpoint_path=config.retrieval.reranker_checkpoint_path)
        self.hybrid = HybridRetriever(config.retrieval, self.store,
                                      self.embed, self.rerank,
                                      output_file=None)
        self._warmed = False

    async def _ensure_warm(self) -> None:
        if not self._warmed:
            self._warmed = True
            n = await self.hybrid.warm_cache()
            if n:
                logger.debug("Warmed embedding cache with %d texts", n)

    async def retrieve(self, query: str, groundtruth: str = "",
                       true_chunks: Optional[List[int]] = None,
                       ) -> Dict[str, Any]:
        await self._ensure_warm()
        t0 = time.perf_counter()
        text, _ = await self.hybrid.perform_hybrid_retrieval(query,
                                                             true_chunks)
        return {
            "query": query,
            "groundtruth": groundtruth,
            "retrieval": text,
            "graph_uuid": self.graph_uuid,
            "retrieval_time": time.perf_counter() - t0,
            "verbose": self.config.retrieval.verbose,
        }

    async def batch_retrieve_from_file(self, queries_path: str,
                                       output_path: str) -> List[Dict]:
        with open(queries_path) as f:
            data = json.load(f)
        queries = data.get("queries", data) if isinstance(data, dict) \
            else data
        results = []
        for item in queries:
            query = item.get("query", "")
            if not query:
                continue
            true_chunks = HybridRetriever.parse_true_chunks(
                item.get("true_chunks") or item.get("true_chunk"))
            try:
                rec = await self.retrieve(query,
                                          item.get("groundtruth", ""),
                                          true_chunks)
            except RerankerError as e:
                logger.error("Aborting batch retrieval: reranker failed in "
                             "strict mode: %s", e)
                raise
            results.append(rec)
            logger.info("Retrieved %d/%d: %.3fs", len(results),
                        len(queries), rec["retrieval_time"])
        out = Path(output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=2, ensure_ascii=False))
        logger.info("Wrote %d retrieval results to %s", len(results), out)
        return results

    def close(self) -> None:
        self.store.close()


class OnlineRetriever:
    """Legacy fulltext-only online retriever (reference:
    src/pipeline/retriever.py:13-240) — superseded by HybridRetriever's
    scheduler but kept for API parity."""

    def __init__(self, config: PipelineConfig, graph_store,
                 schedule_path: Optional[str] = None) -> None:
        self.config = config
        self.store = graph_store
        self.schedule = []
        if schedule_path:
            with open(schedule_path) as f:
                data = json.load(f)
            self.schedule = data.get("queries", data) \
                if isinstance(data, dict) else data
        self.executed: List[Dict] = []
        self._executed_keys: set = set()

    async def check_and_run_queries(self, current_video_time: str
                                    ) -> List[Dict]:
        results = []
        end_time = current_video_time.split("-")[-1].strip()
        for sched in self.schedule:
            t = sched.get("time", "")
            if t > end_time:
                continue
            key = (sched.get("query", ""), t)
            if key in self._executed_keys:
                continue
            query = sched.get("query", "")
            t0 = time.perf_counter()
            ents = self.store.fulltext_search_entities(
                query, self.config.retrieval.top_k_entities)
            text = "Entities: " + ", ".join(e["name"] for e in ents) \
                if ents else f"No results found for query '{query}'"
            rec = {"time": current_video_time, "query": query,
                   "groundtruth": sched.get("groundtruth", ""),
                   "retrieval": text,
                   "retrieval_time": time.perf_counter() - t0}
            results.append(rec)
            self.executed.append(rec)
            self._executed_keys.add(key)
        return results

    def save_results(self, path: Optional[str] = None) -> None:
        out = Path(path or
                   f"outputs/retrieval_results_{self.store.graph_uuid}.json")
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(self.executed, indent=2))
