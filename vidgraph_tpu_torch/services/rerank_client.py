"""Reranker clients.

The reference POSTs ``{query, documents, top_k}`` to an external ``/rerank``
endpoint and treats failures as fatal when strict mode is on
(``RerankerError`` — reference: src/pipeline/retriever_hybrid.py:21-24,
516-653).  Both behaviours are preserved; the default backend reranks with
embedding cosine (one batched matmul).

PyTorch port of ``vidgraph_tpu/services/rerank_client.py``: the cosine and
HTTP clients; ``trained`` (the cross-encoder) raises until ROADMAP slice 6
ports it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.logger import get_logger

logger = get_logger("rerank_client")


class RerankerError(RuntimeError):
    """Raised when reranking fails and strict mode demands an abort."""


class RerankClient:
    async def rerank(self, query: str, documents: Sequence[str],
                     top_k: int) -> List[Tuple[int, float]]:
        """Returns [(original_index, score)] sorted best-first, len<=top_k."""
        raise NotImplementedError


class TPURerankClient(RerankClient):
    def __init__(self, embed_client) -> None:
        self._embed = embed_client

    async def rerank(self, query, documents, top_k):
        if not documents:
            return []
        vecs = await self._embed.aembed([query] + list(documents))
        q, d = vecs[0], vecs[1:]
        scores = d @ q
        order = np.argsort(-scores)[:top_k]
        return [(int(i), float(scores[i])) for i in order]


class HttpRerankClient(RerankClient):
    def __init__(self, endpoint: str, model: str, api_key: str = "",
                 timeout: float = 30.0) -> None:
        self.endpoint = endpoint
        self.model = model
        self.api_key = api_key
        self.timeout = timeout

    async def rerank(self, query, documents, top_k):
        import httpx

        if not documents:
            return []
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        payload = {"model": self.model, "query": query,
                   "documents": list(documents), "top_k": top_k}
        async with httpx.AsyncClient(timeout=self.timeout) as client:
            r = await client.post(self.endpoint, json=payload,
                                  headers=headers)
            r.raise_for_status()
            results = r.json().get("results", [])
        out = []
        for item in results[:top_k]:
            idx = item.get("index")
            if idx is None:
                continue
            out.append((int(idx),
                        float(item.get("relevance_score",
                                       item.get("score", 0.0)))))
        return out


def make_rerank_client(kind: str, embed_client=None, endpoint: str = "",
                       model: str = "", api_key: str = "",
                       checkpoint_path: str = "",
                       ) -> Optional[RerankClient]:
    if kind == "tpu":
        if embed_client is None:
            raise ValueError("tpu reranker needs an embed client")
        return TPURerankClient(embed_client)
    if kind == "trained":
        raise NotImplementedError(
            "the trained cross-encoder reranker is not ported to PyTorch "
            "yet (ROADMAP slice 6)")
    if kind == "http":
        return HttpRerankClient(endpoint, model, api_key)
    if kind in ("none", "", None):
        return None
    raise ValueError(f"unknown reranker backend: {kind}")
