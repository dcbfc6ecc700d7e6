"""Offline relation pruner — deduplicates semantically-equivalent parallel
relations in an exported graph (reference: src/pipeline/prune.py:15-167).

For every ordered node pair with multiple relationships, the relation
sentences ("head relation tail") are embedded (one batched device call
instead of the reference's per-sentence SentenceTransformer calls); if the
relations are mutually similar (pairwise cosine above ``threshold``) only
the one closest to the embedding centroid is kept.

The reference ran this as a standalone script with hard-coded paths; here
it is also wired into the CLI (``vidgraph prune``).
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.logger import get_logger

logger = get_logger("prune")

DEFAULT_SIMILARITY_THRESHOLD = 0.8


class Graph:
    def __init__(self, data: Dict[str, Any], embedder=None,
                 threshold: float = DEFAULT_SIMILARITY_THRESHOLD) -> None:
        from ..models.text_embedder import HashedNGramEmbedder

        self.data = data
        self.threshold = threshold
        self._embedder = embedder or HashedNGramEmbedder()

    @classmethod
    def from_file(cls, path: str, **kw) -> "Graph":
        with open(path) as f:
            return cls(json.load(f), **kw)

    @staticmethod
    def _sentence(rel: Dict[str, Any]) -> str:
        return (f"{rel.get('from_node')} "
                f"{str(rel.get('type', '')).replace('_', ' ').lower()} "
                f"{rel.get('to_node')}")

    def _are_same_context(self, sims: np.ndarray) -> bool:
        """All pairwise similarities above threshold?"""
        n = sims.shape[0]
        iu = np.triu_indices(n, k=1)
        return bool((sims[iu] > self.threshold).all())

    def _get_representative_relation(self, group: List[Dict],
                                     vecs: np.ndarray) -> Dict:
        centroid = vecs.mean(axis=0)
        centroid /= max(np.linalg.norm(centroid), 1e-12)
        scores = vecs @ centroid
        return group[int(np.argmax(scores))]

    def prune_graph(self) -> Dict[str, Any]:
        rels = self.data.get("relationships", [])
        groups: Dict[Tuple[str, str], List[Dict]] = defaultdict(list)
        passthrough: List[Dict] = []
        for rel in rels:
            if rel.get("type") == "FROM_CHUNK":
                passthrough.append(rel)
                continue
            key = (str(rel.get("from_node")), str(rel.get("to_node")))
            groups[key].append(rel)

        kept: List[Dict] = list(passthrough)
        pruned_count = 0
        multi = {k: g for k, g in groups.items() if len(g) > 1}
        # one batched embedding call over every sentence in every group
        all_sentences = [self._sentence(r) for g in multi.values()
                         for r in g]
        if all_sentences:
            all_vecs = self._embedder.embed(all_sentences)
        offset = 0
        for key, group in groups.items():
            if len(group) == 1:
                kept.append(group[0])
                continue
            vecs = all_vecs[offset:offset + len(group)]
            offset += len(group)
            sims = vecs @ vecs.T
            if self._are_same_context(sims):
                rep = self._get_representative_relation(group, vecs)
                kept.append(rep)
                pruned_count += len(group) - 1
            else:
                kept.extend(group)
        out = dict(self.data)
        out["relationships"] = kept
        logger.info("Pruned %d redundant relations (%d -> %d)",
                    pruned_count, len(rels), len(kept))
        return out


def prune_export_file(input_path: str, output_path: str,
                      threshold: float = DEFAULT_SIMILARITY_THRESHOLD,
                      embedder=None) -> str:
    g = Graph.from_file(input_path, threshold=threshold, embedder=embedder)
    pruned = g.prune_graph()
    out = Path(output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(pruned, indent=2, ensure_ascii=False))
    return str(out)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Prune redundant relations in "
                                            "an exported graph JSON")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--threshold", type=float,
                   default=DEFAULT_SIMILARITY_THRESHOLD)
    args = p.parse_args(argv)
    prune_export_file(args.input, args.output, args.threshold)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
