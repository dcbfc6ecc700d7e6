"""VLM extraction: video -> ``vlm_output.json``.

Output schema is bit-compatible with the reference (reference:
src/pipeline/vlm_extractor.py:66-91):
``{"metadata": {run_id, video_path, total_chunks, config}, "results":
[{time, content, chunk_idx, processing_time}]}`` plus a metrics file
``metrics/vlm_{run_id}.json``.

The compute path is redesigned: chunks are decoded with one seek per chunk
and captioned by the configured VLM backend (on-device ViT+captioner by
default; HTTP or deterministic-local otherwise).  With the TPU backend,
decode of chunk N+1 overlaps captioning of chunk N via a thread-pool
prefetch (double buffering across the host/device boundary).
"""
from __future__ import annotations

import asyncio
import json
import time
import uuid as _uuid
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..core.config import PipelineConfig
from ..core.logger import get_logger
from ..core.metrics import MetricsTracker
from ..io.video import count_chunks, iter_chunk_frames
from ..services.vlm_client import make_vlm_client

logger = get_logger("vlm_extractor")


class VLMExtractor:
    def __init__(self, config: PipelineConfig,
                 vlm_client=None) -> None:
        self.config = config
        self.metrics = MetricsTracker()
        self.vlm = vlm_client or make_vlm_client(config.backend.vlm,
                                                 config.vlm)

    async def process_video(self, video_path: str, output_path: str,
                            max_chunks: Optional[int] = None,
                            ) -> Dict[str, Any]:
        run_id = str(_uuid.uuid4())
        vcfg = self.config.video
        total_chunks = count_chunks(video_path, vcfg.chunk_size_seconds)
        if max_chunks:
            total_chunks = min(total_chunks, max_chunks)
        logger.info("Processing %s: %d chunks of %.1fs x %d frames",
                    video_path, total_chunks, vcfg.chunk_size_seconds,
                    vcfg.frames_per_chunk)

        results: List[Dict[str, Any]] = []
        loop = asyncio.get_running_loop()
        chunk_iter = iter_chunk_frames(video_path, vcfg.chunk_size_seconds,
                                       vcfg.frames_per_chunk)

        def _next_chunk():
            return next(chunk_iter, None)

        # Prefetch decode of the next chunk while the current one captions.
        pending = loop.run_in_executor(None, _next_chunk)
        done_chunks = 0
        while True:
            item = await pending
            if item is None or done_chunks >= total_chunks:
                break
            pending = loop.run_in_executor(None, _next_chunk)
            chunk_idx, time_label, frames = item
            t0 = time.perf_counter()
            content = await self.vlm.caption(
                frames,
                system_prompt=self.config.vlm.system_prompt,
                user_prompt=self.config.vlm.user_prompt_template)
            dt = time.perf_counter() - t0
            self.metrics.record_timing("vlm_chunk", dt)
            self.metrics.record_count("frames", len(frames))
            results.append({"time": time_label, "content": content,
                            "chunk_idx": chunk_idx, "processing_time": dt})
            done_chunks += 1
            if done_chunks % 10 == 0:
                logger.info("Captioned %d/%d chunks", done_chunks,
                            total_chunks)

        output = {
            "metadata": {
                "run_id": run_id,
                "video_path": video_path,
                "total_chunks": len(results),
                "config": self.config.to_dict(),
            },
            "results": results,
        }
        out = Path(output_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w", encoding="utf-8") as f:
            json.dump(output, f, indent=2, ensure_ascii=False)
        self.metrics.save_metrics(f"metrics/vlm_{run_id}.json")
        logger.info("Wrote %d chunk captions to %s", len(results), out)
        return output
