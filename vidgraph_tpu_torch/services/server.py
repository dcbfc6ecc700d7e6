"""HTTP serving surface: the framework as a queryable video-memory service.

The reference only CONSUMED OpenAI-compatible services; this exposes the
framework itself over HTTP (stdlib-only — asyncio streams, no web
dependencies) so external clients can ingest captions and query live
memories:

    POST /v1/ingest    {"stream": "cam0", "chunk_id": "...",
                        "content": "...", "time": "MM:SS-MM:SS"}
    POST /v1/query     {"stream": "cam0", "query": "...", "k": 3}
    POST /v1/retrieve  {"graph_uuid": "...", "query": "..."}  (full hybrid)
    GET  /v1/stats

All embedding work runs through the shared device embed client; /v1/query
hits the per-stream memory, /v1/retrieve the persisted graph of a KG run.
"""
from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, Optional

from ..core.config import PipelineConfig
from ..core.logger import get_logger

logger = get_logger("server")

_MAX_BODY = 8 * 1024 * 1024


class VideoMemoryServer:
    def __init__(self, config: Optional[PipelineConfig] = None,
                 host: str = "127.0.0.1", port: int = 8077) -> None:
        from ..parallel.serving import make_embedding_store
        from ..services.embed_client import make_embed_client

        self.config = config or PipelineConfig()
        self.host = host
        self.port = port
        self.embed = make_embed_client(
            self.config.backend.embedder,
            dim=self.config.embedding_memory.dim,
            checkpoint_path=self.config.embedder.checkpoint_path)
        # mesh-aware factory: per-stream memories shard over the serving
        # mesh when one is active (parallel/serving.py)
        self._EmbeddingStore = make_embedding_store
        self.memories: Dict[str, Any] = {}
        self.chunk_meta: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self.retrievers: Dict[str, Any] = {}
        self.requests_served = 0
        self._server: Optional[asyncio.AbstractServer] = None

    # ------------------------------------------------------------- handlers
    async def _ingest(self, body: Dict) -> Dict:
        sid = body["stream"]
        cid = body["chunk_id"]
        content = body["content"]
        if sid not in self.memories:
            self.memories[sid] = self._EmbeddingStore(dim=self.embed.dim)
            self.chunk_meta[sid] = {}
        vec = await self.embed.aembed([content])
        self.memories[sid].add([cid], vec)
        self.chunk_meta[sid][cid] = {"id": cid, "content": content,
                                     "time": body.get("time")}
        return {"ok": True, "stream": sid,
                "memory_size": len(self.memories[sid])}

    async def _query(self, body: Dict) -> Dict:
        sid = body["stream"]
        if sid not in self.memories:
            return {"ok": False, "error": f"unknown stream {sid}"}
        qvec = await self.embed.aembed_query(body["query"])
        hits = self.memories[sid].search(
            qvec[None], k=int(body.get("k", 3)),
            threshold=body.get("threshold"))[0]
        return {"ok": True, "chunks": [
            {**self.chunk_meta[sid][cid], "score": score}
            for cid, score in hits if cid in self.chunk_meta[sid]]}

    async def _retrieve(self, body: Dict) -> Dict:
        from ..pipeline.retriever import OfflineRetriever

        uuid = body["graph_uuid"]
        if uuid not in self.retrievers:
            self.retrievers[uuid] = OfflineRetriever(self.config, uuid,
                                                     embed_client=self.embed)
        rec = await self.retrievers[uuid].retrieve(
            body["query"], body.get("groundtruth", ""))
        return {"ok": True, **rec}

    def _stats(self) -> Dict:
        return {"ok": True, "requests_served": self.requests_served,
                "streams": {sid: len(m) for sid, m in self.memories.items()},
                "graphs_open": list(self.retrievers)}

    # ------------------------------------------------------------ http glue
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request_line = (await reader.readline()).decode()
            if not request_line:
                return
            method, path, _ = request_line.split(" ", 2)
            headers = {}
            while True:
                line = (await reader.readline()).decode()
                if line in ("\r\n", "\n", ""):
                    break
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
            length = min(int(headers.get("content-length", 0)), _MAX_BODY)
            body = {}
            if length:
                body = json.loads(await reader.readexactly(length))

            self.requests_served += 1
            try:
                if method == "POST" and path == "/v1/ingest":
                    resp, code = await self._ingest(body), 200
                elif method == "POST" and path == "/v1/query":
                    resp, code = await self._query(body), 200
                elif method == "POST" and path == "/v1/retrieve":
                    resp, code = await self._retrieve(body), 200
                elif method == "GET" and path == "/v1/stats":
                    resp, code = self._stats(), 200
                else:
                    resp, code = {"ok": False, "error": "not found"}, 404
            except KeyError as e:
                resp, code = {"ok": False,
                              "error": f"missing field {e}"}, 400
            except Exception as e:
                logger.error("handler error: %s", e)
                resp, code = {"ok": False, "error": str(e)}, 500

            payload = json.dumps(resp).encode()
            writer.write(
                f"HTTP/1.1 {code} OK\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: close\r\n\r\n".encode() + payload)
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError,
                json.JSONDecodeError) as e:
            logger.debug("connection error: %s", e)
        finally:
            writer.close()

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        addr = self._server.sockets[0].getsockname()
        self.port = addr[1]
        logger.info("VideoMemoryServer listening on %s:%d", *addr[:2])

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        await self.start()
        async with self._server:
            await self._server.serve_forever()
