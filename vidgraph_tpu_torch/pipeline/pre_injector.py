"""Pre-LLM injection: hierarchical local triplet extraction.

Behavioural parity with reference src/components/pre_llm_injector.py:22-699:

* batch text is token-chunked (``chunk_size``/``chunk_overlap``) and each
  chunk gets one bounded LLM call producing pipe-delimited triplet lines;
* chunk ids are ``{run_uuid}_{batch}_{i}``;
* per-chunk calls run serially or under a Semaphore(parallel_count), each
  with a strict timeout and configurable retries (chunk skipped on final
  failure);
* triplets are deduplicated on (head, relation, tail) lowercase keys with
  source_chunks merged, heads/tails Title-Cased and relations
  underscore->space Title-Cased;
* with subgraph injection enabled: all chunks are embedded (one batched
  device call instead of the reference's N HTTP calls), scored against the
  existing chunk memory with the fused cosine kernel (replacing the
  reference's Python cosine loop over <=5000 Neo4j rows), deduped to the
  top ``top_k_similar_batch`` chunk ids, and an LLM-friendly subgraph
  string ``Subgraph: (Name / ID: b_c)-[REL]->(...)`` is built around each
  with a per-seed external-connection cap and random sampling.

Deviation (documented): chunking counts whitespace words rather than
tiktoken tokens (the reference used TokenTextSplitter); sizes are scaled by
~0.75 so default configs produce comparable chunk counts.
"""
from __future__ import annotations

import asyncio
import random
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.config import (ChunkingConfig, EmbedderConfig, LLMInjectorConfig)
from ..core.logger import get_logger
from .prompts import build_pre_llm_prompt

logger = get_logger("pre_injector")

_WORDS_PER_TOKEN = 0.75  # word-count splitter calibration vs tiktoken


def warn_near_window_boundary(splitter, chunks_text, margin: int,
                              batch_idx: int,
                              slack_tokens: int = 6) -> bool:
    """VERDICT r2 item 9: when the calibrated estimator (not tiktoken)
    decides chunk counts and the batch's estimated token count lands
    within ``slack_tokens`` of a chunk-window boundary, the estimator may
    disagree with exact cl100k by ±1 chunk — surface it in the logs so the
    drift is observable.  Returns True when the warning fired."""
    if (getattr(splitter, "encoder_name", "") != "estimator"
            or not chunks_text):
        return False
    cs, ov = splitter.chunk_size, splitter.chunk_overlap
    slack = (min(margin - ov, cs - margin) if len(chunks_text) > 1
             else cs - margin)
    if 0 <= slack <= slack_tokens:
        logger.warning(
            "batch %s: estimated token count is within %d tokens of a "
            "chunk-window boundary — chunk count (%d) and "
            "{uuid}_{batch}_{i} ids may differ by ±1 vs exact cl100k "
            "tokenization", batch_idx, slack, len(chunks_text))
        return True
    return False


def split_text_by_words(text: str, chunk_size_tokens: int,
                        overlap_tokens: int) -> List[str]:
    """Sliding-window word splitter with overlap (token sizes scaled)."""
    words = text.split()
    size = max(1, int(chunk_size_tokens * _WORDS_PER_TOKEN))
    overlap = max(0, int(overlap_tokens * _WORDS_PER_TOKEN))
    if not words:
        return []
    step = max(1, size - overlap)
    chunks = []
    for start in range(0, len(words), step):
        piece = words[start:start + size]
        if not piece:
            break
        chunks.append(" ".join(piece))
        if start + size >= len(words):
            break
    return chunks


def get_short_chunk_id(full_chunk_id: str) -> str:
    parts = str(full_chunk_id).split("_")
    if len(parts) >= 3:
        return f"{parts[-2]}_{parts[-1]}"
    return "?"


class PreLLMInjector:
    def __init__(self, chunking_config: ChunkingConfig,
                 llm_injector_config: Optional[LLMInjectorConfig],
                 embedder_config: EmbedderConfig,
                 chat_client, embed_client) -> None:
        self.config = chunking_config
        self.llm_injector_config = llm_injector_config
        self.embedder_config = embedder_config
        self.chat = chat_client
        self.embed = embed_client
        from .text_splitter import make_splitter
        self._splitter = make_splitter(
            getattr(chunking_config, "splitter", "token"),
            chunking_config.chunk_size, chunking_config.chunk_overlap,
            word_splitter=split_text_by_words)
        # trace info for the per-batch injection log
        self.last_chunk_details: List[Dict[str, Any]] = []

    # ----------------------------------------------------------------- parse
    @staticmethod
    def parse_pipe_delimited(text: str, chunk_id: str) -> List[Dict[str, Any]]:
        triplets = []
        for line in (text or "").splitlines():
            line = line.strip()
            if not line or "|" not in line:
                continue
            parts = [p.strip() for p in line.split("|")]
            if len(parts) < 3 or not all(parts[:3]):
                continue
            triplets.append({"head": parts[0], "relation": parts[1],
                             "tail": parts[2], "source_chunks": [chunk_id]})
        return triplets

    # ------------------------------------------------------------------ dedupe
    @staticmethod
    def deduplicate_triplets(triplets: List[Dict[str, Any]]
                             ) -> List[Dict[str, Any]]:
        seen: Dict[str, Dict[str, Any]] = {}
        deduped: List[Dict[str, Any]] = []
        for tr in triplets:
            if not isinstance(tr, dict):
                continue
            head = str(tr.get("head", "")).strip().lower()
            relation = str(tr.get("relation", "")).strip().lower()
            tail = str(tr.get("tail", "")).strip().lower()
            sources = tr.get("source_chunks", [])
            if not isinstance(sources, list):
                sources = [sources] if sources else []
            if not head or not relation or not tail:
                continue
            key = f"{head}|{relation}|{tail}"
            if key not in seen:
                entry = {
                    "head": head.title(),
                    "relation": relation.replace("_", " ").title(),
                    "tail": tail.title(),
                    "source_chunks": sorted(set(sources)),
                }
                seen[key] = entry
                deduped.append(entry)
            else:
                seen[key]["source_chunks"] = sorted(
                    set(seen[key]["source_chunks"]) | set(sources))
        return deduped

    # --------------------------------------------------------------- chunk LLM
    async def _extract_chunk_triplets(self, chunk_text: str, chunk_id: str
                                      ) -> Tuple[List[Dict], Optional[str]]:
        """One bounded LLM call; returns (triplets, error)."""
        prompt = build_pre_llm_prompt(chunk_text,
                                      self.config.max_triplets_per_chunk)
        retries = max(1, self.config.chunk_timeout_retries)
        # The wall timeout exists to bound HANGS of external HTTP servers
        # (reference: src/components/pre_llm_injector.py chunk timeouts).
        # An in-process device client cannot be cancelled mid-dispatch —
        # asyncio.wait_for only abandons the awaiting coroutine while the
        # decode thread runs to completion — so a first remote compile
        # slower than the timeout fails EVERY chunk of the batch and then
        # retries behind the same decode lock (measured: one congested
        # 180 s+ compile cost a sweep epoch its first two batches).  For
        # coalescing clients, widen the bound to cover worst-case remote
        # compile; the work always completes and is otherwise discarded.
        timeout_s = self.config.chunk_timeout_seconds
        if getattr(self.chat, "coalesces_batches", False):
            timeout_s = max(timeout_s, 600.0)
        last_err: Optional[str] = None
        for attempt in range(retries):
            try:
                raw = await asyncio.wait_for(
                    self.chat.complete(prompt, temperature=0.05,
                                       max_tokens=512),
                    timeout=timeout_s)
                return self.parse_pipe_delimited(raw, chunk_id), None
            except asyncio.TimeoutError:
                last_err = f"timeout after {timeout_s}s"
            except Exception as e:
                last_err = str(e)
            logger.warning("Chunk %s attempt %d failed: %s", chunk_id,
                           attempt + 1, last_err)
        logger.warning("Skipping chunk %s after %d attempts", chunk_id,
                       retries)
        return [], last_err

    async def _run_chunk_extractions(self, chunk_data: List[Dict]
                                     ) -> List[Dict]:
        self.last_chunk_details = []
        results: List[Tuple[List[Dict], Optional[str]]] = []
        parallel = self.config.batch_llm_parallelism
        width = max(1, self.config.parallel_count)
        if getattr(self.chat, "coalesces_batches", False):
            # in-process batched client (TPUChatClient): co-submitted
            # prompts share ONE ragged-batch device dispatch, so the
            # semaphore exists only to bound memory — submit everything
            # (the serial/parallel toggle protects external HTTP servers,
            # which this client is not)
            parallel = True
            width = max(width, getattr(self.chat, "max_batch", 32))
        if parallel:
            sem = asyncio.Semaphore(width)

            async def bounded(c):
                async with sem:
                    return await self._extract_chunk_triplets(c["content"],
                                                              c["id"])

            results = await asyncio.gather(
                *[bounded(c) for c in chunk_data])
        else:
            for c in chunk_data:
                results.append(
                    await self._extract_chunk_triplets(c["content"],
                                                       c["id"]))
        triplets: List[Dict] = []
        for c, (trs, err) in zip(chunk_data, results):
            self.last_chunk_details.append({
                "id": c["id"], "content": c["content"],
                "triplets": trs, "error": err})
            triplets.extend(trs)
        return triplets

    # ------------------------------------------------------------ similarity
    async def _embed_chunks(self, chunk_data: List[Dict]) -> None:
        texts = [c["content"] for c in chunk_data]
        try:
            vecs = await self.embed.aembed(texts)   # one batched device call
            for c, v in zip(chunk_data, vecs):
                c["embedding"] = [float(x) for x in np.asarray(v, np.float32)]
        except Exception as e:
            logger.warning("Chunk embedding failed: %s", e)

    def _top_similar_existing(self, chunk_data: List[Dict], graph_store
                              ) -> List[Tuple[str, float]]:
        """Fused-kernel similarity of new chunks vs existing chunk memory;
        max-dedupe by chunk id; top ``top_k_similar_batch``."""
        new_vecs = [c.get("embedding") for c in chunk_data
                    if c.get("embedding")]
        if not new_vecs:
            return []
        q = np.asarray(new_vecs, np.float32)
        ids, scores = graph_store.similarity_to_chunks(q)
        if not ids:
            return []
        per_chunk_k = max(1, self.embedder_config
                          .top_k_chunk_with_batch_similarity)
        final: Dict[str, float] = {}
        for row in scores:
            order = np.argsort(-row)[:per_chunk_k]
            for j in order:
                cid, s = ids[int(j)], float(row[int(j)])
                if cid not in final or s > final[cid]:
                    final[cid] = s
        ranked = sorted(final.items(), key=lambda x: x[1], reverse=True)
        return ranked[:self.embedder_config.top_k_similar_batch]

    def _extract_subgraph_for_chunk_id(self, chunk_id: str, graph_store,
                                       rng: Optional[random.Random] = None
                                       ) -> str:
        """Compact subgraph string around a chunk's entities (format parity:
        ``Subgraph: (Name / ID: b_c)-[REL]->(Name / ID: b_c), ...``)."""
        seeds = graph_store.entities_with_source_chunk(chunk_id)
        if not seeds:
            return ""
        seed_set = set(seeds)
        max_conn = getattr(self.config, "max_connection_subgraph", 2)
        internal, external_by_seed = [], {}
        seen_keys = set()
        for seed in seeds:
            for h, typ, t, _props in graph_store.relations_of_entity(seed):
                if graph_store.get_entity(h) is None or \
                        graph_store.get_entity(t) is None:
                    continue  # skip chunk endpoints
                key = (h, typ, t)
                if key in seen_keys:
                    continue
                seen_keys.add(key)
                if h in seed_set and t in seed_set:
                    internal.append(key)
                else:
                    anchor = h if h in seed_set else t
                    external_by_seed.setdefault(anchor, []).append(key)
        # seed from the uuid-free short id with a STABLE hash: builtin
        # hash() is PYTHONHASHSEED-randomised per process, which made the
        # sampled subgraph context (hence the whole deterministic build)
        # vary run-to-run; the run uuid must not enter the seed either.
        rng = rng or random.Random(
            zlib.crc32(get_short_chunk_id(chunk_id).encode()))
        chosen = list(internal)
        for seed, rels in external_by_seed.items():
            if len(rels) <= max_conn:
                chosen.extend(rels)
            else:
                chosen.extend(rng.sample(rels, max_conn))
        if not chosen:
            return ""

        def fmt(name: str) -> str:
            props = graph_store.get_entity(name) or {}
            ids = props.get("source_chunk_ids") or []
            sid = get_short_chunk_id(ids[0]) if ids else "?"
            return f"({name} / ID: {sid})"

        parts = [f"{fmt(h)}-[{typ}]->{fmt(t)}" for h, typ, t in chosen]
        return "Subgraph: " + ", ".join(parts)

    # ---------------------------------------------------------------- entry
    async def extract_local_triplets(self, content: str,
                                     network_info: str = "",
                                     graph_store=None, batch_idx: int = 0,
                                     run_uuid: str = "",
                                     ) -> Tuple[List[Dict], List[Dict],
                                                Dict[str, str]]:
        if hasattr(self._splitter, "split_text_with_margin"):
            chunks_text, margin = self._splitter.split_text_with_margin(
                content)
            warn_near_window_boundary(self._splitter, chunks_text, margin,
                                      batch_idx)
        else:
            chunks_text = self._splitter.split_text(content)
        chunk_data = []
        for i, text in enumerate(chunks_text):
            cid = (f"{run_uuid}_{batch_idx}_{i}" if run_uuid
                   else f"chunk_{batch_idx}_{i}")
            chunk_data.append({"id": cid, "content": text, "index": i,
                               "embedding": None})
        if not chunk_data:
            logger.warning("No chunks produced from content")
            return [], [], {}

        subgraphs: Dict[str, str] = {}
        use_similarity = bool(self.llm_injector_config and
                              self.llm_injector_config
                              .subgraph_extraction_injection)
        t_embed = time.perf_counter()
        if use_similarity:
            await self._embed_chunks(chunk_data)
            t_sim = time.perf_counter()
            if graph_store is not None:
                top_similar = self._top_similar_existing(chunk_data,
                                                         graph_store)
                for cid, _score in top_similar:
                    s = self._extract_subgraph_for_chunk_id(cid, graph_store)
                    if s:
                        subgraphs[cid] = s
        else:
            # embeddings are still needed for chunk nodes (vector retrieval)
            await self._embed_chunks(chunk_data)
            t_sim = time.perf_counter()
        t_llm = time.perf_counter()

        triplets = await self._run_chunk_extractions(chunk_data)
        t_done = time.perf_counter()
        triplets = self.deduplicate_triplets(triplets)
        logger.info(
            "Extracted %d local triplets from %d chunks "
            "(embed %.2fs, sim+subgraph %.2fs, llm %.2fs)",
            len(triplets), len(chunk_data), t_sim - t_embed,
            t_llm - t_sim, t_done - t_llm)
        return triplets, chunk_data, subgraphs
