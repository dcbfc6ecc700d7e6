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

PyTorch port of ``vidgraph_tpu/pipeline/acs.py``.  ``acs.backend`` selects
``networkx`` (the exact cross-check), ``xla`` (the option's name in the JAX
package: here the device sweep as torch ops on ``core/platform.py::
device()``) or ``auto`` (the device sweep from ``_AUTO_XLA_MIN_NODES``
nodes up, NetworkX below, as in the JAX package).  The device sweep is the
JAX package's dense linear algebra: BFS by repeated boolean matmul, exact
all-pairs Brandes betweenness as level-synchronised matmul sweeps, Fagiolo
directed clustering, power-iteration PageRank and parallel Louvain, all in
``_acs_fused`` from an edge list.  No Pallas kernel is involved.

Float32 throughout with TF32 off (``_full_f32``): hop counts and path
counts are integers, exact in float32 below 2^24, as in JAX.  Each
``lax.while_loop`` of the JAX code becomes a Python loop: the Brandes
sweeps run to a bound read once from the device (the deepest BFS level),
and the BFS reads its "still growing" flag once every ``_BFS_CHECK`` steps,
not once a step.  A failure of the fused sweep raises (the JAX package
falls back to its per-metric path; ``update_metrics`` still turns any
error into its ``{"error": ...}`` record, the reference's contract).
Louvain's random half-node update masks are the JAX package's, drawn from
``PRNGKey(42)`` by ``core/prng.py``, so its labels, community count and
modularity are the JAX package's too.
"""
from __future__ import annotations

import contextlib
import functools
import math
import random
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core import prng
from ..core.config import ACSConfig
from ..core.logger import get_logger
from ..core.platform import device

logger = get_logger("acs_automata")

# the JAX package's crossover (NetworkX below 96 nodes); kept so that the
# port's metrics equal the reference's at every size
_AUTO_XLA_MIN_NODES = 96
# BFS steps between two reads of the "frontier still grows" flag
_BFS_CHECK = 8

_F32 = torch.float32


@contextlib.contextmanager
def _full_f32() -> Iterator[None]:
    """Float32 matmuls in full float32 (TF32 off) inside the block."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(prec)


# ---------------------------------------------------------------------------
# device sweeps (adjacency padded to a power of two >= 128)
# ---------------------------------------------------------------------------

def _pad_dim(n: int) -> int:
    """Power-of-two padding (the JAX package's, which bounds its compiled
    shapes); kept so that the padded problems are the same."""
    p = 128
    while p < n:
        p *= 2
    return p


def _distance_matrix(adj_u: torch.Tensor, valid: torch.Tensor,
                     max_steps: int) -> torch.Tensor:
    """All-pairs shortest-path hop counts via boolean-matmul BFS.

    adj_u: [N,N] f32 0/1 (directed or undirected, no self loops, padded)
    valid: [N] f32 0/1 node mask
    Returns D [N,N] f32 with hop counts, +inf where unreachable/invalid.

    Steps until the reachability frontier stops growing (at most
    ``max_steps + 1``); the flag is read every ``_BFS_CHECK`` steps, and
    the steps past the last growth change nothing.
    """
    n = adj_u.shape[0]
    eye = torch.eye(n, dtype=_F32, device=adj_u.device)
    vmask = valid[:, None] * valid[None, :]
    reach = torch.clamp((eye + adj_u) * vmask, max=1.0)
    dist = torch.where(eye > 0, 0.0,
                       torch.where(adj_u * vmask > 0, 1.0, math.inf))
    k = 2
    while k <= max_steps + 1:
        for _ in range(min(_BFS_CHECK, max_steps + 2 - k)):
            new_reach = torch.clamp(reach + reach @ adj_u, max=1.0) * vmask
            newly = (new_reach > 0) & (reach == 0)
            dist = torch.where(newly, float(k), dist)
            reach = new_reach
            k += 1
        if not bool(newly.any()):
            break
    return torch.where(vmask > 0, dist, math.inf)


def _betweenness_sweeps(adj_d: torch.Tensor, valid: torch.Tensor,
                        dist: torch.Tensor, max_steps: int) -> torch.Tensor:
    """Brandes forward/backward sweeps given precomputed hop distances.

    Forward sweep: sigma[s,v] (shortest-path counts) built level by level
    with sigma_k = (sigma_{k-1} @ A) masked to D==k.  Backward sweep:
    dependencies delta_k = sigma_k * ((1+delta_{k+1})/sigma_{k+1} @ A^T)
    masked to D==k.  bc[v] = sum_s delta[s,v], normalised by
    1/((n-1)(n-2)) (networkx directed convention, endpoints excluded).
    ``max_steps`` levels each way, a static bound.
    """
    n = adj_d.shape[0]
    vmask = valid[:, None] * valid[None, :]
    a = adj_d * vmask
    sigma = torch.eye(n, dtype=_F32, device=adj_d.device)
    for k in range(1, max_steps + 1):
        prev = sigma * (dist == k - 1.0)
        sigma = sigma + (prev @ a) * (dist == float(k))
    delta = torch.zeros_like(sigma)
    for k in range(max_steps, 0, -1):
        contrib = torch.where(dist == k + 1.0,
                              (1.0 + delta) / torch.clamp(sigma, min=1.0),
                              0.0)
        delta = delta + sigma * (contrib @ a.T) * (dist == float(k))
    bc = delta.sum(dim=0)
    n_valid = valid.sum()
    denom = torch.clamp((n_valid - 1.0) * (n_valid - 2.0), min=1.0)
    return torch.where(valid > 0, bc / denom, 0.0)


def _bucket_steps(k: int) -> int:
    """Power-of-two step bucket >= max(8, k) (the JAX package's)."""
    b = 8
    while b < k:
        b *= 2
    return b


def _betweenness(adj_d: torch.Tensor, valid: torch.Tensor,
                 max_steps: int) -> torch.Tensor:
    """Exact all-pairs betweenness (Brandes) as dense level-synchronised
    matmuls: directed hop distances via the early-exit BFS, then sweeps
    bounded by the measured max finite level (bucketed), read once."""
    vmask = valid[:, None] * valid[None, :]
    a = adj_d * vmask
    dist = _distance_matrix(a, valid, max_steps)
    lvl = int(torch.where(torch.isinf(dist), -1.0, dist).max())
    steps = min(max_steps, _bucket_steps(max(1, lvl)))
    return _betweenness_sweeps(a, valid, dist, steps)


def _assortativity(adj_d: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Directed degree assortativity (networkx convention: Pearson
    correlation of source OUT-degree vs target IN-degree over edges) as
    adjacency contractions."""
    vmask = valid[:, None] * valid[None, :]
    a = adj_d * vmask
    dout = a.sum(1)
    din = a.sum(0)
    m = torch.clamp(a.sum(), min=1.0)
    sx = torch.sum(dout * dout)
    sy = torch.sum(din * din)
    sxy = dout @ a @ din
    sxx = torch.sum(dout ** 3)
    syy = torch.sum(din ** 3)
    cov = sxy / m - (sx / m) * (sy / m)
    varx = sxx / m - (sx / m) ** 2
    vary = syy / m - (sy / m) ** 2
    denom = torch.sqrt(torch.clamp(varx * vary, min=0.0))
    return torch.where(denom > 0, cov / denom, 0.0)


def _directed_clustering(adj_d: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Fagiolo (2007) directed clustering coefficient, averaged over the
    valid nodes (``nx.average_clustering`` on a DiGraph), as three matmuls:
    C_i = (A+A^T)^3_ii / (2(d_tot(d_tot-1) - 2 d_bidir))."""
    vmask = valid[:, None] * valid[None, :]
    a = adj_d * vmask
    s = a + a.T
    s3 = s @ s @ s
    tri = torch.diagonal(s3) / 2.0
    d_tot = a.sum(0) + a.sum(1)
    d_bi = torch.diagonal(a @ a)
    denom = d_tot * (d_tot - 1.0) - 2.0 * d_bi
    c = torch.where(denom > 0, tri / denom, 0.0)
    n_valid = torch.clamp(valid.sum(), min=1.0)
    return torch.sum(torch.where(valid > 0, c, 0.0)) / n_valid


def _pagerank(adj_d: torch.Tensor, valid: torch.Tensor, iters: int = 50,
              damping: float = 0.85) -> torch.Tensor:
    """Power-iteration PageRank on the directed adjacency (dangling nodes
    redistribute uniformly), matching networkx semantics."""
    n_valid = torch.clamp(valid.sum(), min=1.0)
    out_deg = adj_d.sum(dim=1)
    dangling = (out_deg == 0) & (valid > 0)
    p = valid / n_valid
    trans = adj_d / torch.clamp(out_deg[:, None], min=1.0)
    for _ in range(iters):
        spread = p @ trans
        dangling_mass = torch.sum(torch.where(dangling, p, 0.0))
        p = damping * (spread + dangling_mass * valid / n_valid) \
            + (1 - damping) * valid / n_valid
    return p


@functools.lru_cache(maxsize=16)
def louvain_masks(n: int, levels: int = 3, iters: int = 20,
                  seed: int = 42) -> torch.Tensor:
    """The random half-node update masks, bool [levels, iters, n], that
    ``vidgraph_tpu/pipeline/acs.py::_louvain`` draws from
    ``PRNGKey(seed)``: per level ``key, sub = split(key)``, then
    ``split(sub, iters)`` and one ``bernoulli(0.5, (n,))`` a key.  Drawn
    on the host (``core/prng.py``) and cached: the caller must not write
    to them."""
    key = prng.PRNGKey(seed)
    levels_out = []
    for _ in range(levels):
        key, sub = prng.split(key)
        levels_out.append(torch.stack(
            [prng.bernoulli(k, 0.5, (n,)) for k in prng.split(sub, iters)]))
    return torch.stack(levels_out)


def _one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(labels, n).to(_F32)


def _louvain(adj_u: torch.Tensor, valid: torch.Tensor,
             masks: Optional[torch.Tensor] = None, levels: int = 3,
             iters: int = 20, resolution: float = 1.0
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Parallel Louvain community detection as dense matmuls.

    Synchronous best-move label updates applied to a random half of the
    nodes per iteration (``masks[level, iter]``, bool [levels, iters, N];
    ``louvain_masks`` when None), then contraction, ``levels`` times.
    S = A @ C (node->community weights), tot = k @ C (community degrees),
    gain = S - res * k_i (tot_c - k_i C_ic) / 2m; every term is an integer
    until the division, so the same masks give the JAX package's labels.

    Returns (labels [N] int64 over original nodes, modularity f32,
    n_communities f32) — modularity evaluated on the ORIGINAL graph.
    """
    n = adj_u.shape[0]
    dev = adj_u.device
    if masks is None:
        masks = louvain_masks(n, levels, iters)
    masks = masks.to(dev)
    if masks.shape != (levels, iters, n):
        raise ValueError(f"masks {tuple(masks.shape)}, want "
                         f"{(levels, iters, n)}")
    vmask = valid[:, None] * valid[None, :]
    a0 = adj_u * vmask
    k0 = a0.sum(dim=1)
    two_m = a0.sum()
    safe_two_m = torch.clamp(two_m, min=1e-9)
    live = valid > 0

    glob = torch.arange(n, device=dev)   # original node -> community
    a = a0
    for li in range(levels):
        # degrees/volume of the CURRENT (possibly contracted) graph; the
        # contraction C^T A C already doubles internal weight on the
        # diagonal, so the plain row sum IS the community degree.
        diag = torch.diagonal(a)
        k = a.sum(dim=1)
        lvl_two_m = torch.clamp(a.sum(), min=1e-9)
        off = a - torch.diag(diag)   # edges to c, self-loop excluded
        labels = torch.arange(n, device=dev)
        for it in range(iters):
            c = _one_hot(labels, n)
            s = off @ c
            tot = k @ c
            gain = s - resolution * k[:, None] * \
                (tot[None, :] - k[:, None] * c) / lvl_two_m
            # only neighbour communities (s>0) and the current one are
            # candidate targets, as in sequential Louvain
            gain = torch.where((s > 0) | (c > 0), gain, -1e30)
            best = torch.argmax(gain, dim=1)
            labels = torch.where(masks[li, it] & live, best, labels)
        glob = labels[glob]
        c = _one_hot(labels, n)
        a = c.T @ a @ c  # self-loops carry internal community weight

    cg = _one_hot(glob, n) * valid[:, None]
    within = torch.diagonal(cg.T @ a0 @ cg)
    tot = k0 @ cg
    q = torch.where(two_m > 0,
                    (within.sum() - resolution * (tot ** 2).sum()
                     / safe_two_m) / safe_two_m, 0.0)
    n_comms = (cg.sum(dim=0) > 0).sum().to(_F32)
    return glob, q, n_comms


def _acs_fused(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
               valid: torch.Tensor, keep: torch.Tensor, pad: int,
               masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every device metric from an EDGE LIST: the dense adjacency is
    scattered on the device (``src``/``dst`` padded with zero-weight
    entries), and the result is 13 float32 scalars, read in one copy.
    ``keep`` is the host-seeded robustness retention mask, ``masks`` the
    Louvain update masks (``louvain_masks`` when None)."""
    n = pad
    dev = src.device
    adj_d = torch.zeros(pad * pad, dtype=_F32, device=dev).scatter_reduce_(
        0, src * pad + dst, w, reduce="amax").view(pad, pad)
    vmask = valid[:, None] * valid[None, :]
    a = adj_d * vmask
    u = torch.clamp(a + a.T, max=1.0)
    n_valid = valid.sum()
    eye = torch.eye(n, dtype=_F32, device=dev)
    offdiag = (1.0 - eye) * vmask

    # ---- undirected distance family -----------------------------------
    du = _distance_matrix(u, valid, n)
    finite = torch.isfinite(du) & (vmask > 0)
    inv = torch.where(finite & (offdiag > 0),
                      1.0 / torch.clamp(du, min=1e-9), 0.0)
    eff = inv.sum() / torch.clamp(n_valid * (n_valid - 1.0), min=1.0)
    sizes = finite.to(_F32).sum(dim=1) * valid
    wcc_count = torch.where(valid > 0, 1.0 / torch.clamp(sizes, min=1.0),
                            0.0).sum()
    largest = sizes.max()
    r0 = torch.argmax(sizes)
    member = finite[r0].to(_F32) * valid
    mm = member[:, None] * member[None, :] * offdiag
    in_cc = (mm > 0) & finite
    apl_num = torch.where(in_cc, du, 0.0).sum()
    apl_den = in_cc.to(_F32).sum()
    apl = apl_num / torch.clamp(apl_den, min=1.0)
    diam = torch.where(in_cc, du, 0.0).max()

    # ---- betweenness (directed, exact Brandes) -------------------------
    dd = _distance_matrix(a, valid, n)
    lvl = int(max(float(torch.where(torch.isinf(dd), -1.0, dd).max()), 1.0))
    bc = _betweenness_sweeps(a, valid, dd, lvl)
    avg_bt = bc.sum() / torch.clamp(n_valid, min=1.0)
    max_bt = bc.max()

    # ---- the remaining metrics ------------------------------------------
    clustering = _directed_clustering(adj_d, valid)
    pr = _pagerank(adj_d, valid)
    top10 = torch.topk(pr, 10).values
    pr_total = pr.sum()
    pagerank_top10 = torch.where(pr_total > 0,
                                 top10.sum() / pr_total * 100.0, 0.0)
    assort = _assortativity(adj_d, valid)
    m_edges = a.sum()
    robustness = torch.where(
        m_edges > 0,
        (a * keep[:, None] * keep[None, :]).sum()
        / torch.clamp(m_edges, min=1.0), 1.0)
    _, louvain_q, louvain_k = _louvain(u, valid, masks)

    return torch.stack([
        eff, apl, diam, wcc_count, largest, avg_bt, max_bt, clustering,
        pagerank_top10, assort, robustness, louvain_k, louvain_q])


def _padded(adj: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """``adj`` in the top-left corner of a zero [pad, pad] float32 matrix
    and its [pad] valid mask, on the port's device."""
    n = adj.shape[0]
    pad = _pad_dim(n)
    a = np.zeros((pad, pad), np.float32)
    a[:n, :n] = adj
    valid = np.zeros(pad, np.float32)
    valid[:n] = 1.0
    dev = device()
    return torch.from_numpy(a).to(dev), torch.from_numpy(valid).to(dev)


class ACSAutomata:
    def __init__(self, graph_store, config: Optional[ACSConfig] = None
                 ) -> None:
        self.store = graph_store
        self.config = config or ACSConfig()
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
            n = len(names)
            backend = self.config.backend
            if backend == "auto":
                backend = "xla" if n >= _AUTO_XLA_MIN_NODES else "networkx"

            metrics = self._compute(names, adj, backend)
            metrics["computational_time"] = time.perf_counter() - start
            self.metrics_cache.update(metrics)
            self.last_update_time = time.time()
            return metrics
        except Exception as e:
            logger.error("Error computing network metrics: %s", e)
            return {"error": str(e),
                    "computational_time": time.perf_counter() - start}

    def _fused(self, adj: np.ndarray) -> List[float]:
        """The 13 scalars of ``_acs_fused`` for ``adj`` (n >= 3, m > 0):
        the JAX package's edge-list padding and robustness mask."""
        n = adj.shape[0]
        rows, cols = np.nonzero(adj)
        e = len(rows)
        pad = _pad_dim(n)
        while 4 * pad < e:
            pad *= 2
        e_pad = 4 * pad
        src = np.zeros(e_pad, np.int64)
        dst = np.zeros(e_pad, np.int64)
        w = np.zeros(e_pad, np.float32)
        src[:e] = rows
        dst[:e] = cols
        w[:e] = 1.0         # padding entries scatter weight 0
        v_p = np.zeros(pad, np.float32)
        v_p[:n] = 1.0
        keep = np.ones(pad, np.float32)
        if n > 10:
            k = int(self.config.robustness_removal_fraction * n)
            rng = random.Random(42)
            for i in rng.sample(range(n), min(k, n)):
                keep[i] = 0.0
        dev = device()
        with _full_f32():
            vals = _acs_fused(*(torch.from_numpy(x).to(dev)
                                for x in (src, dst, w, v_p, keep)), pad)
            return vals.cpu().tolist()

    # ------------------------------------------------------------- computation
    def _compute(self, names: List[str], adj: np.ndarray, backend: str
                 ) -> Dict[str, Any]:
        import networkx as nx

        n = len(names)
        m = int(adj.sum())
        und = np.minimum(adj + adj.T, 1.0)
        np.fill_diagonal(und, 0.0)

        density = m / (n * (n - 1)) if n >= 2 else 0.0
        avg_degree = (2 * m) / n if n else 0.0
        u_deg = und.sum(axis=1)
        avg_unique_neighbors = float(u_deg.mean()) if n else 0.0

        # ---- the fused device sweep: every heavy metric; no fallback ----
        fused = None
        if backend == "xla" and n >= 3 and m > 0:
            fused = self._fused(adj)

        # ---- distance-matrix family -------------------------------------
        if fused is not None:
            eff, apl, diam = fused[0], fused[1], int(fused[2])
            wcc_count, largest_wcc = int(round(fused[3])), int(fused[4])
            if largest_wcc < 2:
                apl = None
        elif n >= 2:
            if backend == "xla":
                eff, apl, diam, wcc_count, largest_wcc = \
                    self._distance_family_xla(adj, und)
            else:
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

        G = None

        def _G():
            nonlocal G
            if G is None:
                G = self._nx_from_adj(adj)
            return G

        # ---- betweenness: exact device Brandes, or nx sampled (reference) -
        try:
            if fused is not None:
                avg_bt, max_bt = fused[5], fused[6]
            elif backend == "xla" and n >= 3:
                bc = self._betweenness_xla(adj)
                avg_bt = float(bc.mean())
                max_bt = float(bc.max())
            else:
                bt = nx.betweenness_centrality(
                    _G(), k=min(self.config.betweenness_k, n), seed=42)
                avg_bt = sum(bt.values()) / len(bt) if bt else 0.0
                max_bt = max(bt.values()) if bt else 0.0
        except Exception:
            avg_bt = max_bt = 0.0

        try:
            if fused is not None:
                assort = fused[9]
            elif backend == "xla" and m > 0:
                with _full_f32():
                    assort = float(_assortativity(*_padded(adj)))
            else:
                assort = nx.degree_assortativity_coefficient(_G())
            if math.isnan(assort):
                assort = 0.0
        except Exception:
            assort = 0.0

        # ---- robustness: seeded 10% node removal, edge-retention ratio ----
        try:
            if fused is not None and n > 10:
                robustness = fused[10]
            elif n > 10 and m > 0:
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
            if fused is not None:
                clustering = fused[7]
            elif backend == "xla" and n >= 2:
                clustering = float(self._clustering_xla(adj))
            else:
                clustering = nx.average_clustering(_G())
        except Exception:
            clustering = 0.0

        # ---- pagerank top-10 mass ------------------------------------------
        try:
            if fused is not None:
                pagerank_top10 = fused[8]
            elif backend == "xla" and n >= 2:
                pr = self._pagerank_xla(adj)
                total = pr.sum()
                pagerank_top10 = float(np.sort(pr)[::-1][:10].sum()
                                       / total * 100.0) if total > 0 else 0.0
            else:
                pr = np.asarray(list(nx.pagerank(_G()).values())) \
                    if n else np.zeros(0)
                total = pr.sum()
                pagerank_top10 = float(np.sort(pr)[::-1][:10].sum()
                                       / total * 100.0) if total > 0 else 0.0
        except Exception:
            pagerank_top10 = 0.0

        # ---- louvain ---------------------------------------------------------
        # acs.louvain = "device" takes the parallel device formulation on
        # the xla path (community counts may differ from NetworkX's);
        # "networkx" pins the exact seeded NetworkX Louvain.
        louvain_communities, louvain_modularity = 0, 0.0
        exact_louvain = getattr(self.config, "louvain", "device") \
            == "networkx"
        try:
            if fused is not None and not exact_louvain:
                louvain_communities = int(round(fused[11]))
                louvain_modularity = fused[12]
            elif backend == "xla" and n >= 2 and not exact_louvain:
                louvain_communities, louvain_modularity = \
                    self._louvain_xla(adj)
            else:
                Gu = _G().to_undirected()
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

    # -- device family ------------------------------------------------------
    def _distance_family_xla(self, adj: np.ndarray, und: np.ndarray):
        n = adj.shape[0]
        max_steps = min(n, 128)  # hop-count cap; graphs here are shallow
        with _full_f32():
            D = _distance_matrix(*_padded(und), max_steps)
            D = D.cpu().numpy()[:n, :n]
        finite = np.isfinite(D)
        off = ~np.eye(n, dtype=bool)

        # efficiency over all ordered pairs (unreachable contribute 0)
        with np.errstate(divide="ignore"):
            inv = np.where(finite & off, 1.0 / np.maximum(D, 1e-9), 0.0)
        eff = float(inv[off].sum() / (n * (n - 1))) if n >= 2 else 0.0

        # components from reachability
        comp_id = np.full(n, -1)
        cid = 0
        for i in range(n):
            if comp_id[i] < 0:
                members = np.where(finite[i])[0]
                comp_id[members] = cid
                comp_id[i] = cid
                cid += 1
        sizes = np.bincount(comp_id[comp_id >= 0])
        wcc_count = len(sizes)
        largest = int(sizes.max()) if len(sizes) else 0

        # avg path length + diameter on the largest component
        if largest >= 2:
            big = np.where(comp_id == np.argmax(sizes))[0]
            sub = D[np.ix_(big, big)]
            mask = np.isfinite(sub) & ~np.eye(len(big), dtype=bool)
            apl = float(sub[mask].mean()) if mask.any() else None
            diam = int(sub[mask].max()) if mask.any() else 0
        else:
            apl, diam = None, 0
        return eff, apl, diam, wcc_count, largest

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

    def _betweenness_xla(self, adj: np.ndarray) -> np.ndarray:
        n = adj.shape[0]
        with _full_f32():
            bc = _betweenness(*_padded(adj), min(n, 128))
            return bc.cpu().numpy()[:n]

    def _clustering_xla(self, adj: np.ndarray) -> float:
        with _full_f32():
            return float(_directed_clustering(*_padded(adj)))

    def _pagerank_xla(self, adj: np.ndarray) -> np.ndarray:
        n = adj.shape[0]
        with _full_f32():
            return _pagerank(*_padded(adj)).cpu().numpy()[:n]

    def _louvain_xla(self, adj: np.ndarray,
                     masks: Optional[torch.Tensor] = None):
        """Undirected parallel Louvain on the device; returns
        (n_communities, modularity) matching the NetworkX call's outputs.
        ``masks`` as ``_louvain`` takes them (``louvain_masks`` when
        None)."""
        und = np.minimum(adj + adj.T, 1.0)
        np.fill_diagonal(und, 0.0)
        with _full_f32():
            _, q, n_comms = _louvain(*_padded(und), masks)
            return int(n_comms), float(q)

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
