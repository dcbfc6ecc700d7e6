"""Stream sources and live-KG glue for the realtime engine.

``video_frame_source`` turns an mp4 into the frame iterator the engine
consumes; ``LiveKGIngestor`` runs the full triplet-extraction pipeline
(pre-injection -> refinement -> graph injection) as the engine's background
``kg_extractor``, so each stream grows a queryable knowledge graph while
frames keep flowing.
"""
from __future__ import annotations

import asyncio
from typing import Any, Dict, Iterator, Optional

import numpy as np

from ..core.config import PipelineConfig
from ..core.logger import get_logger

logger = get_logger("stream_ingest")


def video_frame_source(path: str, loop: bool = False,
                       max_dim: int = 720) -> Iterator[np.ndarray]:
    """RGB frames from a video file at native order (engine does pacing)."""
    import cv2

    from ..io.video import resize_max_dim

    while True:
        cap = cv2.VideoCapture(path)
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield cv2.cvtColor(resize_max_dim(frame, max_dim),
                                   cv2.COLOR_BGR2RGB)
        finally:
            cap.release()
        if not loop:
            return


class LiveKGIngestor:
    """Per-stream incremental KG construction driven by engine captions.

    Each stream gets its own graph store (uuid = stream id); caption chunks
    are buffered into reference-sized batches and pushed through
    pre-injection -> refinement -> graph injection exactly like the offline
    KG builder, but off the ingest path.
    """

    def __init__(self, config: PipelineConfig, chat_client, embed_client,
                 store_factory=None) -> None:
        from ..graph import open_graph_store
        from ..pipeline.pre_injector import PreLLMInjector
        from ..pipeline.refiner import GlobalRefiner

        self.config = config
        self._store_factory = store_factory or (
            lambda sid: open_graph_store(config, sid, load_existing=False))
        self.stores: Dict[str, Any] = {}
        self.pre = PreLLMInjector(config.chunking, config.llm_injector,
                                  config.embedder, chat_client, embed_client)
        self.refiner = GlobalRefiner(config.chunking, chat_client)
        self._buffers: Dict[str, list] = {}
        self._batch_idx: Dict[str, int] = {}
        self._locks: Dict[str, asyncio.Lock] = {}

    def store_for(self, sid: str):
        if sid not in self.stores:
            self.stores[sid] = self._store_factory(sid)
            self._buffers[sid] = []
            self._batch_idx[sid] = 0
            self._locks[sid] = asyncio.Lock()
        return self.stores[sid]

    async def __call__(self, sid: str, cid: str, caption: str,
                       label: str) -> None:
        """Engine kg_extractor hook: buffer the chunk, flush full batches."""
        store = self.store_for(sid)
        async with self._locks[sid]:
            self._buffers[sid].append({"time": label, "content": caption})
            if len(self._buffers[sid]) >= self.config.kg.batch_size:
                batch = self._buffers[sid]
                self._buffers[sid] = []
                await self._process_batch(sid, store, batch)

    async def flush(self) -> None:
        for sid, buf in list(self._buffers.items()):
            if buf:
                async with self._locks[sid]:
                    batch, self._buffers[sid] = self._buffers[sid], []
                    if batch:
                        await self._process_batch(sid, self.stores[sid],
                                                  batch)

    async def _process_batch(self, sid: str, store, batch) -> None:
        from ..pipeline.kg_builder import KGBuilder
        from ..pipeline.refiner import GlobalRefiner

        batch_idx = self._batch_idx[sid]
        self._batch_idx[sid] += 1
        aggregated = "\n\n".join(
            f"Time: {item['time']}\nContent: {item['content']}"
            for item in batch)
        triplets, chunks, subgraphs = await self.pre.extract_local_triplets(
            aggregated, "", store, batch_idx, sid)
        operations: Optional[Dict] = None
        if triplets:
            if self.config.llm_injector.subgraph_extraction_injection:
                ops = await self.refiner.refine_triplets_instruction_based(
                    triplets, subgraphs,
                    self.config.chunking.global_triplet_limit)
                triplets = GlobalRefiner.ops_to_triplets(ops, triplets)
                operations = ops
            else:
                triplets = await self.refiner.refine_triplets(
                    triplets, "", self.config.chunking.global_triplet_limit)
        cleaned = KGBuilder._clean_data(triplets)
        for c in chunks:
            c.setdefault("time", batch[-1]["time"])
        store.add_batch_to_graph(cleaned, batch, batch_idx,
                                 text_chunks=chunks, operations=operations)
        logger.debug("Live KG %s: batch %d -> %d triplets, graph now "
                     "%d nodes", sid, batch_idx, len(cleaned),
                     store.get_node_count())

    def close(self) -> None:
        for store in self.stores.values():
            store.close()
