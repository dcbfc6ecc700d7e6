"""ACS Automata — network-science metrics per batch.

Metric set, names, and rounding match the reference (reference:
src/pipeline/acs_automata.py:21-324): node/edge counts, density, average
degree, unique-neighbour degree, global efficiency, average path length on
the largest component, degree/betweenness centrality, degree assortativity,
robustness under seeded 10% random node removal (edge-retention ratio),
diameter estimate, clustering coefficient, weakly connected components,
top-10-node PageRank mass, Louvain communities/modularity, label Shannon
entropy, and computational time.  The graph is all GraphNodes of the run
(entities + chunks) with every relationship between them (typed +
FROM_CHUNK), as a simple digraph.

PyTorch port of ``vidgraph_tpu/pipeline/acs.py``: the NetworkX backend,
which is the JAX package's exact cross-check, and nothing else yet.

Deviations (ROADMAP §3): ``acs.backend: auto`` resolves to ``networkx`` at
every graph size (the JAX package switches to its fused XLA sweep at 96
nodes), and logs it once per ``ACSAutomata``, so once a run;
``acs.backend: xla`` raises ``NotImplementedError``.  The fused metric
sweep as torch ops is the next item of the ROADMAP's module queue.
"""
from __future__ import annotations

import math
import random
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.config import ACSConfig
from ..core.logger import get_logger

logger = get_logger("acs_automata")


def _check_backend(backend: str) -> None:
    if backend == "xla":
        raise NotImplementedError(
            "acs.backend: xla (the fused device metric sweep) is not ported "
            "to PyTorch yet; use networkx or auto")
    if backend == "auto":
        logger.info("acs.backend auto runs networkx at every graph size "
                    "(the device sweep is not ported yet)")


class ACSAutomata:
    def __init__(self, graph_store, config: Optional[ACSConfig] = None
                 ) -> None:
        self.store = graph_store
        self.config = config or ACSConfig()
        _check_backend(self.config.backend)
        self.metrics_cache: Dict[str, Any] = {}
        self.last_update_time = 0.0

    # ------------------------------------------------------------- graph pull
    def _build_arrays(self) -> Tuple[List[str], np.ndarray, Dict[str, int]]:
        """Node list + directed simple adjacency (entities + chunks, typed
        rels + FROM_CHUNK collapsed to simple edges)."""
        s = self.store
        names = list(s.entities.keys()) + list(s.chunks.keys())
        idx = {n: i for i, n in enumerate(names)}
        n = len(names)
        adj = np.zeros((n, n), np.float32)
        for (h, _typ, t) in s.rels:
            if h in idx and t in idx:
                adj[idx[h], idx[t]] = 1.0
        for (e, c) in s.from_chunk:
            if e in idx and c in idx:
                adj[idx[e], idx[c]] = 1.0
        np.fill_diagonal(adj, 0.0)
        return names, adj, idx

    # ----------------------------------------------------------------- entry
    def update_metrics(self) -> Dict[str, Any]:
        start = time.perf_counter()
        try:
            names, adj, _ = self._build_arrays()
            metrics = self._compute(names, adj)
            metrics["computational_time"] = time.perf_counter() - start
            self.metrics_cache.update(metrics)
            self.last_update_time = time.time()
            return metrics
        except Exception as e:
            logger.error("Error computing network metrics: %s", e)
            return {"error": str(e),
                    "computational_time": time.perf_counter() - start}

    # ------------------------------------------------------------- computation
    def _compute(self, names: List[str], adj: np.ndarray) -> Dict[str, Any]:
        import networkx as nx

        n = len(names)
        m = int(adj.sum())
        und = np.minimum(adj + adj.T, 1.0)
        np.fill_diagonal(und, 0.0)

        density = m / (n * (n - 1)) if n >= 2 else 0.0
        avg_degree = (2 * m) / n if n else 0.0
        u_deg = und.sum(axis=1)
        avg_unique_neighbors = float(u_deg.mean()) if n else 0.0

        # ---- distance-matrix family -------------------------------------
        if n >= 2:
            eff, apl, diam, wcc_count, largest_wcc = \
                self._distance_family_nx(adj, und)
        else:
            eff, apl, diam = 0.0, None, 0
            wcc_count, largest_wcc = (1 if n else 0), n

        # ---- degree centrality -------------------------------------------
        if n >= 2:
            deg_total = adj.sum(axis=0) + adj.sum(axis=1)
            dc = deg_total / (n - 1)
            avg_dc, max_dc = float(dc.mean()), float(dc.max())
        else:
            avg_dc = max_dc = 0.0

        G = self._nx_from_adj(adj)

        # ---- betweenness: nx sampled (reference) ---------------------------
        try:
            bt = nx.betweenness_centrality(
                G, k=min(self.config.betweenness_k, n), seed=42)
            avg_bt = sum(bt.values()) / len(bt) if bt else 0.0
            max_bt = max(bt.values()) if bt else 0.0
        except Exception:
            avg_bt = max_bt = 0.0

        try:
            assort = nx.degree_assortativity_coefficient(G)
            if math.isnan(assort):
                assort = 0.0
        except Exception:
            assort = 0.0

        # ---- robustness: seeded 10% node removal, edge-retention ratio ----
        try:
            if n > 10 and m > 0:
                k = int(self.config.robustness_removal_fraction * n)
                rng = random.Random(42)
                removed = set(rng.sample(range(n), min(k, n)))
                keep = np.asarray([i not in removed for i in range(n)])
                robustness = float(adj[np.ix_(keep, keep)].sum() / m)
            else:
                robustness = 1.0
        except Exception:
            robustness = 0.0

        # ---- clustering (directed, as nx.average_clustering on DiGraph) ---
        try:
            clustering = nx.average_clustering(G)
        except Exception:
            clustering = 0.0

        # ---- pagerank top-10 mass ------------------------------------------
        try:
            pr = np.asarray(list(nx.pagerank(G).values())) \
                if n else np.zeros(0)
            total = pr.sum()
            pagerank_top10 = float(np.sort(pr)[::-1][:10].sum()
                                   / total * 100.0) if total > 0 else 0.0
        except Exception:
            pagerank_top10 = 0.0

        # ---- louvain: exact seeded NetworkX ----------------------------------
        louvain_communities, louvain_modularity = 0, 0.0
        try:
            Gu = G.to_undirected()
            comms = nx.community.louvain_communities(Gu, seed=42)
            louvain_communities = len(comms)
            louvain_modularity = nx.community.modularity(Gu, comms) \
                if Gu.number_of_edges() else 0.0
        except Exception as e:
            logger.warning("Louvain computation failed: %s", e)

        label_entropy = self._label_entropy()

        return {
            "node_count": n,
            "relationship_count": m,
            "density": round(density, 4),
            "avg_degree": round(avg_degree, 4),
            "avg_unique_neighbors": round(avg_unique_neighbors, 4),
            "global_efficiency": round(eff, 4),
            "avg_path_length": round(apl, 4) if apl is not None else None,
            "avg_degree_centrality": round(avg_dc, 4),
            "max_degree_centrality": round(max_dc, 4),
            "avg_betweenness_centrality": round(avg_bt, 4),
            "max_betweenness_centrality": round(max_bt, 4),
            "degree_assortativity": round(float(assort), 4),
            "graph_robustness": round(robustness, 4),
            "diameter_estimate": int(diam),
            "clustering_coefficient": round(float(clustering), 4),
            "weakly_connected_components": int(wcc_count),
            "largest_wcc_size": int(largest_wcc),
            "pagerank_top10_percent": round(pagerank_top10, 2),
            "louvain_communities": louvain_communities,
            "louvain_modularity": (round(louvain_modularity, 4)
                                   if louvain_modularity is not None
                                   else None),
            "label_entropy": label_entropy,
        }

    @staticmethod
    def _nx_from_adj(adj: np.ndarray):
        import networkx as nx

        G = nx.DiGraph()
        G.add_nodes_from(range(adj.shape[0]))
        rows, cols = np.nonzero(adj)
        G.add_edges_from(zip(rows.tolist(), cols.tolist()))
        return G

    def _distance_family_nx(self, adj: np.ndarray, und: np.ndarray):
        import networkx as nx

        n = adj.shape[0]
        G = self._nx_from_adj(adj)
        Gu = G.to_undirected()
        small = self.config.exact_efficiency_max_nodes
        if n <= small:
            eff = nx.global_efficiency(Gu)
        else:
            rng = random.Random(42)
            nodes = list(Gu.nodes())
            ssum, scount = 0.0, 0
            for _ in range(min(self.config.sample_sources, n)):
                src = rng.choice(nodes)
                lengths = nx.single_source_shortest_path_length(Gu, src)
                ssum += sum(1.0 / d for t, d in lengths.items()
                            if t != src and d > 0)
                scount += len(nodes) - 1
            eff = ssum / scount if scount else 0.0

        comps = list(nx.connected_components(Gu))
        wcc_count = len(comps)
        largest_set = max(comps, key=len) if comps else set()
        largest = len(largest_set)
        if largest >= 2:
            sub = Gu.subgraph(largest_set)
            if largest <= small:
                apl = nx.average_shortest_path_length(sub)
                try:
                    diam = nx.diameter(sub)
                except Exception:
                    diam = min(n // 2, 50)
            else:
                rng = random.Random(42)
                nodes = list(sub.nodes())
                tsum, tcount = 0.0, 0
                for _ in range(min(self.config.sample_sources, largest)):
                    src = rng.choice(nodes)
                    lengths = nx.single_source_shortest_path_length(sub, src)
                    tsum += sum(d for t, d in lengths.items() if t != src)
                    tcount += len(lengths) - 1
                apl = tsum / tcount if tcount else None
                diam = min(n // 2, 50)
        else:
            apl, diam = None, 0
        return eff, apl, diam, wcc_count, largest

    # -- entropy ------------------------------------------------------------------
    def _label_entropy(self) -> float:
        counts = {
            "GraphNode": len(self.store.entities) + len(self.store.chunks),
            "Entity": len(self.store.entities),
            "Chunk": len(self.store.chunks),
        }
        counts = {k: v for k, v in counts.items() if v > 0}
        total = sum(counts.values())
        if total == 0:
            return 0.0
        entropy = -sum((c / total) * math.log(c / total, 2)
                       for c in counts.values())
        return round(entropy, 4)
