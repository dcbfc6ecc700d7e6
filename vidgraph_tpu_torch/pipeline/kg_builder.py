"""KG Builder — the central orchestrator (reference:
src/pipeline/kg_builder.py:22-344).

Per run: fresh UUID, logs/ reset, per-batch injection trace files.  Per
batch: aggregate ``Time:/Content:`` text -> network info -> pre-extraction
(token chunking + per-chunk LLM) -> global refinement (instruction-based
with subgraph context iff ``subgraph_extraction_injection``; legacy
otherwise; final LLM consolidation only when refinement is disabled) ->
clean/dedupe -> graph injection (with merge/prune/link operations) ->
chunk-count validation -> ACS metrics -> scheduled online retrieval ->
batch metrics (metrics/kg_{uuid}.json + metrics/{uuid}_batch_metrics_kg.json
when ``saving_batch_metrics``).
"""
from __future__ import annotations

import json
import time
import uuid as _uuid
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..core.config import PipelineConfig
from ..core.logger import get_logger
from ..core.metrics import MetricsTracker
from ..graph import open_graph_store
from ..services.embed_client import make_embed_client
from ..services.llm_client import make_chat_client
from ..services.rerank_client import make_rerank_client
from .acs import ACSAutomata
from .injector import LLMInjector
from .network_info import NetworkInfoProvider
from .pre_injector import PreLLMInjector
from .refiner import GlobalRefiner
from .retriever_hybrid import HybridRetriever

logger = get_logger("kg_builder")


class KGBuilder:
    def __init__(self, config: PipelineConfig, graph_store=None,
                 chat_client=None, embed_client=None,
                 rerank_client=None, run_uuid: Optional[str] = None,
                 load_existing: bool = False) -> None:
        self.config = config
        self.run_uuid = run_uuid or str(_uuid.uuid4())
        self.metrics = MetricsTracker()

        b = config.backend
        self.chat = chat_client or make_chat_client(
            b.llm, endpoint=config.llm_injector.endpoint,
            model=config.llm_injector.model_name,
            api_key=config.llm_injector.api_key,
            checkpoint_path=config.llm_injector.checkpoint_path)
        self.embed = embed_client or make_embed_client(
            b.embedder, dim=config.embedding_memory.dim,
            endpoint=config.embedder.endpoint, model=config.embedder.model,
            api_key=config.embedder.api_key,
            checkpoint_path=config.embedder.checkpoint_path)
        self.rerank = rerank_client
        if self.rerank is None and config.retrieval.use_reranker:
            self.rerank = make_rerank_client(
                b.reranker, embed_client=self.embed,
                endpoint=config.retrieval.reranker_endpoint,
                model=config.retrieval.reranker_model,
                api_key=config.retrieval.reranker_api_key,
                checkpoint_path=config.retrieval.reranker_checkpoint_path)

        self.store = graph_store if graph_store is not None else \
            open_graph_store(config, self.run_uuid,
                             load_existing=load_existing)
        self.network_info = NetworkInfoProvider(self.store)
        self.pre_injector = PreLLMInjector(
            config.chunking, config.llm_injector, config.embedder,
            self.chat, self.embed)
        self.global_refiner = (GlobalRefiner(config.chunking, self.chat)
                               if config.chunking.enable_global_refinement
                               else None)
        self.llm_injector = LLMInjector(config.llm_injector, self.chat,
                                        config.chunking.max_new_triplets)
        self.acs_automata = ACSAutomata(self.store, config.acs)
        self.online_retriever: Optional[HybridRetriever] = None

    def _completed_batches(self) -> int:
        """Highest contiguous batch index already persisted (resume point).

        The reference had no mid-run checkpointing — a crashed KG build
        restarted from scratch with a new UUID (SURVEY §5.4).  Here the
        store persists after every batch, so a run can resume from where
        it stopped: chunk ids are ``{uuid}_{batch}_{i}``."""
        done = set()
        for cid in getattr(self.store, "chunks", {}):
            parts = str(cid).split("_")
            if len(parts) >= 3 and parts[-2].isdigit():
                done.add(int(parts[-2]))
        nxt = 0
        while nxt in done:
            nxt += 1
        return nxt

    # -------------------------------------------------------------------- main
    async def build_knowledge_graph(self, vlm_json_path: str,
                                    retrieval_schedule_path: Optional[str]
                                    = None, resume: bool = False,
                                    max_batches: Optional[int] = None
                                    ) -> str:
        logger.info("Starting KG construction from %s (uuid=%s)",
                    vlm_json_path, self.run_uuid)
        logs_dir = Path("logs")
        if not resume and logs_dir.exists():
            # Clear STALE INJECTION TRACES only.  rmtree of the whole dir
            # (pre-round-5) unlinked every module's already-open FileHandler
            # target, so the kg process's own file logs (refiner guard
            # counts, parse warnings, store op applications) silently went
            # to unlinked inodes for the rest of the run.
            for stale in logs_dir.glob("injection_*.log"):
                try:
                    stale.unlink()
                except OSError:
                    pass
        logs_dir.mkdir(parents=True, exist_ok=True)

        with open(vlm_json_path) as f:
            vlm_data = json.load(f)
        results = vlm_data["results"]
        bs = self.config.kg.batch_size
        total_batches = (len(results) + bs - 1) // bs
        start_batch = 0
        if resume:
            start_batch = self._completed_batches()
            logger.info("Resuming run %s at batch %d/%d", self.run_uuid,
                        start_batch, total_batches)
        if max_batches is not None:
            total_batches = min(total_batches, max_batches)

        if retrieval_schedule_path:
            self.online_retriever = HybridRetriever(
                self.config.retrieval, self.store, self.embed, self.rerank,
                schedule_path=retrieval_schedule_path)
            logger.info("Online retriever armed with %d scheduled queries",
                        len(self.online_retriever.retrieval_schedule))

        try:
            for batch_idx in range(start_batch, total_batches):
                await self._process_batch(results, batch_idx, total_batches,
                                          logs_dir)
            self.metrics.save_metrics(f"metrics/kg_{self.run_uuid}.json")
            logger.info("KG construction complete. Graph UUID: %s",
                        self.run_uuid)
            return self.run_uuid
        finally:
            self.store.close()
            if self.online_retriever:
                await self.online_retriever.close()

    async def _process_batch(self, results: List[Dict], batch_idx: int,
                             total_batches: int, logs_dir: Path) -> None:
        t_batch = time.perf_counter()
        bs = self.config.kg.batch_size
        batch = results[batch_idx * bs: (batch_idx + 1) * bs]
        logger.info("Processing batch %d/%d (%d items)", batch_idx + 1,
                    total_batches, len(batch))

        t0 = time.perf_counter()
        aggregated = "\n\n".join(
            f"Time: {item['time']}\nContent: {item['content']}"
            for item in batch)
        aggregation_time = time.perf_counter() - t0
        current_video_time = batch[-1]["time"] if batch else "00:00"

        trace_file = logs_dir / (f"injection_{self.run_uuid}_batch_"
                                 f"{batch_idx + 1}.log")
        self._trace(trace_file, "BATCH ITEMS", aggregated)
        self.llm_injector.trace_file = str(trace_file)

        t0 = time.perf_counter()
        network_info = self.network_info.get_info()
        network_info_time = time.perf_counter() - t0

        # Step 1: pre-extraction
        t_llm = time.perf_counter()
        pre_triplets, text_chunks, subgraphs = \
            await self.pre_injector.extract_local_triplets(
                aggregated, network_info, self.store, batch_idx,
                self.run_uuid)
        self._trace(trace_file, "SPLITTER OUTPUT", json.dumps(
            self.pre_injector.last_chunk_details, indent=2, default=str))

        # Step 2: refinement / consolidation
        operations: Optional[Dict[str, Any]] = None
        global_limit = self.config.chunking.global_triplet_limit
        if self.global_refiner and pre_triplets:
            if self.config.llm_injector.subgraph_extraction_injection:
                ops = await self.global_refiner \
                    .refine_triplets_instruction_based(
                        pre_triplets, subgraphs, global_limit,
                        grounding_text=aggregated)
                triplets = GlobalRefiner.ops_to_triplets(ops, pre_triplets)
                operations = ops
                self._trace(trace_file, "REFINER OPERATIONS",
                            json.dumps(ops, indent=2, default=str))
            else:
                triplets = await self.global_refiner.refine_triplets(
                    pre_triplets, network_info, global_limit)
        elif pre_triplets:
            triplets = await self.llm_injector.extract_triplets(
                pre_triplets, network_info)
        else:
            triplets = []
        llm_time = time.perf_counter() - t_llm

        # Step 3: clean
        t0 = time.perf_counter()
        cleaned = self._clean_data(triplets)
        clean_time = time.perf_counter() - t0

        # Step 4: graph injection
        t0 = time.perf_counter()
        # carry the chunk time label onto chunk nodes for retrieval output
        for c in text_chunks:
            c.setdefault("time", current_video_time)
            c.setdefault("embedding_model", self.config.kg.embedding_model)
        inject_timings = self.store.add_batch_to_graph(
            cleaned, batch_data=batch, batch_idx=batch_idx,
            text_chunks=text_chunks, operations=operations)
        graph_time = time.perf_counter() - t0

        chunk_counts = self.store.get_chunk_counts()
        logger.info("Chunk node counts: %s", chunk_counts)

        # Step 5: ACS metrics
        t0 = time.perf_counter()
        acs_metrics = self.acs_automata.update_metrics()
        acs_time = time.perf_counter() - t0

        # Step 6: scheduled online retrieval
        retrieval_metrics: List[Dict] = []
        if self.online_retriever:
            queries_run = await self.online_retriever.check_and_run_queries(
                current_video_time)
            retrieval_metrics.extend(queries_run)

        self._record_batch_metrics(
            batch_idx, time.perf_counter() - t_batch,
            {"aggregation": aggregation_time,
             "network_info": network_info_time,
             "llm_extraction": llm_time,
             "data_cleaning": clean_time,
             "neo4j_injection": graph_time,
             **inject_timings,
             "acs_metrics": acs_time},
            retrieval_metrics, acs_metrics)
        logger.info("Batch %d completed in %.2fs", batch_idx + 1,
                    time.perf_counter() - t_batch)

    # ------------------------------------------------------------------- utils
    @staticmethod
    def _trace(trace_file: Path, label: str, text: str) -> None:
        try:
            with open(trace_file, "a", encoding="utf-8") as f:
                f.write(f"\n===== {label} =====\n{text}\n"
                        f"===== END {label} =====\n")
        except OSError:
            pass

    @staticmethod
    def _clean_data(triplets: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Normalise + dedupe (reference: src/pipeline/kg_builder.py:273-301):
        lowercase keys for dedupe, Title-Case output, relation underscores
        become spaces."""
        cleaned = []
        seen = set()
        for tr in triplets:
            head = str(tr.get("head", "") or "").strip().lower()
            tail = str(tr.get("tail", "") or "").strip().lower()
            rel = str(tr.get("relation", "") or "").strip().upper()
            if not head or not tail or not rel:
                continue
            key = f"{head}|{rel}|{tail}"
            if key in seen:
                continue
            seen.add(key)
            cleaned.append({
                "head": head.title(),
                "relation": rel.replace("_", " ").title(),
                "tail": tail.title(),
                "source_chunks": tr.get("source_chunks") or [],
            })
        return cleaned

    def _record_batch_metrics(self, batch_idx: int, total_time: float,
                              timings: Dict[str, float],
                              retrieval_metrics: List[Dict],
                              acs_metrics: Dict[str, Any]) -> None:
        batch_metrics = {
            "batch_idx": batch_idx,
            "run_uuid": self.run_uuid,
            "timestamp": time.time(),
            "total_time": total_time,
            **timings,
            "retrieval_queries": retrieval_metrics,
            "acs_metrics": acs_metrics,
        }
        self.metrics.add_batch_metrics(batch_metrics)
        if not self.config.saving_batch_metrics:
            return
        try:
            out_path = Path(f"metrics/{self.run_uuid}_batch_metrics_kg.json")
            existing = []
            if out_path.exists():
                try:
                    existing = json.loads(out_path.read_text())
                except json.JSONDecodeError:
                    existing = []
            existing.append({
                "batch_idx": batch_idx,
                "timestamp": time.time(),
                "total_time": total_time,
                "network_metrics": acs_metrics,
            })
            out_path.parent.mkdir(parents=True, exist_ok=True)
            out_path.write_text(json.dumps(existing, indent=2, default=str))
        except Exception as e:
            logger.warning("Failed to save batch network metrics: %s", e)
