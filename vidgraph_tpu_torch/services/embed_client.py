"""Embedding clients — device-first, HTTP optional.

Every call site that hit an OpenAI-compatible embeddings endpoint in the
reference (reference: src/components/neo4j_handler.py:27-31,
src/components/pre_llm_injector.py:207-221,
src/pipeline/retriever_hybrid.py:41-47) goes through this interface; the
default backend computes embeddings in-process on the TPU (batched hashed
n-gram projection or transformer), so the N+1 HTTP pattern of the
reference's post-compression disappears.
"""
from __future__ import annotations

import asyncio
from typing import Sequence

import numpy as np

from ..core.logger import get_logger

logger = get_logger("embed_client")


class EmbedClient:
    dim: int

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    def embed_query(self, text: str) -> np.ndarray:
        return self.embed([text])[0]

    async def aembed(self, texts: Sequence[str]) -> np.ndarray:
        return await asyncio.to_thread(self.embed, texts)

    async def aembed_query(self, text: str) -> np.ndarray:
        return (await self.aembed([text]))[0]


class TPUEmbedClient(EmbedClient):
    def __init__(self, kind: str = "hash", dim: int = 512, **kw) -> None:
        from ..models.text_embedder import make_embedder
        self._impl = make_embedder(kind, dim=dim, **kw)
        self.dim = dim

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        return self._impl.embed(list(texts))


class HttpEmbedClient(EmbedClient):
    """OpenAI-compatible /embeddings endpoint."""

    def __init__(self, endpoint: str, model: str, api_key: str = "",
                 dim: int = 1536, timeout: float = 60.0) -> None:
        self.endpoint = endpoint.rstrip("/")
        if not self.endpoint.endswith("/embeddings"):
            self.endpoint += "/embeddings"
        self.model = model
        self.api_key = api_key
        self.dim = dim
        self.timeout = timeout

    def embed(self, texts: Sequence[str]) -> np.ndarray:
        import httpx

        if not texts:
            return np.zeros((0, self.dim), np.float32)
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        with httpx.Client(timeout=self.timeout) as client:
            r = client.post(self.endpoint,
                            json={"model": self.model, "input": list(texts)},
                            headers=headers)
            r.raise_for_status()
            data = r.json()["data"]
        data.sort(key=lambda d: d.get("index", 0))
        out = np.asarray([d["embedding"] for d in data], np.float32)
        self.dim = out.shape[1]
        return out


def make_embed_client(kind: str, dim: int = 512, endpoint: str = "",
                      model: str = "", api_key: str = "",
                      checkpoint_path: str = "") -> EmbedClient:
    if kind in ("tpu", "hash"):
        return TPUEmbedClient("hash", dim=dim)
    if kind in ("transformer", "hybrid"):
        kw = {}
        if checkpoint_path:
            # sidecar meta json records the trained architecture
            import json
            from pathlib import Path

            meta_path = Path(checkpoint_path).with_suffix(".json")
            if meta_path.exists():
                meta = json.loads(meta_path.read_text())
                kw = {k: meta[k] for k in
                      ("width", "layers", "heads", "max_len") if k in meta}
                dim = meta.get("dim", dim)
            kw["checkpoint_path"] = checkpoint_path
        client = TPUEmbedClient(kind, dim=dim, **kw)
        client.dim = client._impl.dim   # hybrid concatenates channels
        return client
    if kind == "http":
        return HttpEmbedClient(endpoint, model, api_key)
    raise ValueError(f"unknown embedder backend: {kind}")
