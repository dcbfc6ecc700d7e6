"""The port's ACS device sweep (``vidgraph_tpu_torch/pipeline/acs.py``,
torch ops, on the CPU here) against the JAX package's XLA backend on the
same graphs: the randomized stores of ``tests/test_acs.py``, the graphs of
``tests/test_betweenness.py`` and ``bench.py``'s 926-node Barabási–Albert
graph.

Tolerance 1e-5 (absolute and relative, float32 sums in another order;
hop and path counts are integers, exact in both).  The metric records are
rounded to 4 decimals by both packages, so there every value but Louvain's
is equal.  Louvain draws random half-node masks: fed JAX's masks (drawn
here with ``jax.random`` in ``_louvain``'s own split order) the port gives
the same labels; with its own ``torch.Generator`` it is held to
``tests/test_acs.py::test_xla_louvain_modularity_parity``'s criteria.
"""
import os

os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import networkx as nx  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import vidgraph_tpu.pipeline.acs as jacs  # noqa: E402
import vidgraph_tpu_torch.pipeline.acs as tacs  # noqa: E402
from vidgraph_tpu.core.config import ACSConfig as JConfig  # noqa: E402
from vidgraph_tpu.graph.embedded import EmbeddedGraphStore  # noqa: E402
from vidgraph_tpu_torch.core.config import ACSConfig as TConfig  # noqa: E402

TOL = 1e-5
LOUVAIN = ("louvain_communities", "louvain_modularity")


def _random_store(n_entities=40, n_rels=80, seed=0):
    """``tests/test_acs.py``'s store."""
    rng = np.random.default_rng(seed)
    s = EmbeddedGraphStore("acs", persist_dir=None, persist=False, dim=8)
    names = [f"E{i}" for i in range(n_entities)]
    batch = [{"time": "00:00-00:04", "content": "x"}]
    trips = []
    for _ in range(n_rels):
        h, t = rng.choice(names, 2, replace=False)
        trips.append({"head": h, "relation": f"r{rng.integers(3)}",
                      "tail": t, "source_chunks": ["acs_0_0"]})
    chunks = [{"id": "acs_0_0", "content": "x", "index": 0,
               "embedding": [1.0] * 8}]
    s.add_batch_to_graph(trips, batch, 0, text_chunks=chunks)
    return s


class _Nodes:
    """A store with ``n`` entities and no relations: ``_compute`` reads
    only the node names (bench.py's stand-in)."""

    def __init__(self, n):
        self.entities = {f"n{i}": {} for i in range(n)}
        self.chunks = {}


def _ba_adj(n=926):
    """bench.py's ACS graph: ``barabasi_albert_graph(926, 2, seed=0)``."""
    return nx.to_numpy_array(
        nx.barabasi_albert_graph(n, 2, seed=0)).astype(np.float32)


def _betweenness_graphs():
    """The graphs of ``tests/test_betweenness.py``."""
    out = {}
    path = np.zeros((4, 4), np.float32)
    for i in range(3):
        path[i, i + 1] = 1.0
    out["path"] = path
    star = np.zeros((6, 6), np.float32)
    for i in range(1, 6):
        star[0, i] = star[i, 0] = 1.0
    out["star"] = star
    diamond = np.zeros((4, 4), np.float32)
    diamond[0, 1] = diamond[0, 2] = diamond[1, 3] = diamond[2, 3] = 1.0
    out["diamond"] = diamond
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        adj = (rng.random((30, 30)) < 0.12).astype(np.float32)
        np.fill_diagonal(adj, 0.0)
        out[f"random{seed}"] = adj
    split = np.zeros((6, 6), np.float32)
    split[0, 1] = split[1, 2] = split[3, 4] = split[4, 5] = 1.0
    out["disconnected"] = split
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        adj = (rng.random((25, 25)) < 0.15).astype(np.float32)
        np.fill_diagonal(adj, 0.0)
        out[f"clustering{seed}"] = adj
    return out


def _pad(adj, pad=128):
    n = adj.shape[0]
    a = np.zeros((pad, pad), np.float32)
    a[:n, :n] = adj
    valid = np.zeros(pad, np.float32)
    valid[:n] = 1.0
    return a, valid


def jax_masks(n, levels=3, iters=20, seed=42):
    """The masks ``vidgraph_tpu.pipeline.acs._louvain`` draws from
    ``PRNGKey(seed)``: a split per level, ``iters`` keys per level, one
    ``bernoulli(0.5, (n,))`` per key.  bool [levels, iters, n]."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(levels):
        key, sub = jax.random.split(key)
        out.append([np.asarray(jax.random.bernoulli(k, 0.5, (n,)))
                    for k in jax.random.split(sub, iters)])
    return torch.from_numpy(np.array(out))


def _assert_metrics_equal(got, want, skip=LOUVAIN):
    assert "error" not in got and "error" not in want, (got, want)
    assert set(got) == set(want)
    for key in want:
        if key in skip or key == "computational_time":
            continue
        a, b = got[key], want[key]
        if isinstance(b, float) and a is not None:
            assert abs(a - b) <= TOL, (key, a, b)
        else:
            assert a == b, (key, a, b)


def _fused_inputs(adj):
    """The edge list, masks and pad that ``ACSAutomata._compute`` gives
    ``_acs_fused``, with the first tenth of the nodes removed by ``keep``."""
    n = adj.shape[0]
    rows, cols = np.nonzero(adj)
    pad = jacs._pad_dim(n)
    while 4 * pad < len(rows):
        pad *= 2
    src = np.zeros(4 * pad, np.int32)
    dst = np.zeros(4 * pad, np.int32)
    w = np.zeros(4 * pad, np.float32)
    src[:len(rows)], dst[:len(rows)], w[:len(rows)] = rows, cols, 1.0
    valid = np.zeros(pad, np.float32)
    valid[:n] = 1.0
    keep = np.ones(pad, np.float32)
    keep[: n // 10] = 0.0
    return src, dst, w, valid, keep, pad


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_sweep_metrics_equal_jax(seed):
    """``acs.backend: xla`` in both packages on ``tests/test_acs.py``'s
    stores: every metric but Louvain equal."""
    s = _random_store(seed=seed)
    want = jacs.ACSAutomata(s, JConfig(backend="xla")).update_metrics()
    got = tacs.ACSAutomata(s, TConfig(backend="xla")).update_metrics()
    _assert_metrics_equal(got, want)


@pytest.mark.parametrize("name", ["random_store0", "random_store3", "ba926"])
def test_fused_sweep_matches_jax_with_jax_masks(name):
    """``_acs_fused``'s 13 scalars, Louvain's included, fed JAX's masks."""
    if name == "ba926":
        adj = _ba_adj()
    else:
        acs = jacs.ACSAutomata(_random_store(seed=int(name[-1])))
        adj = acs._build_arrays()[1]
    src, dst, w, valid, keep, pad = _fused_inputs(adj)
    want = np.asarray(jacs._acs_fused(
        *(jnp.asarray(x) for x in (src, dst, w, valid, keep)),
        jax.random.PRNGKey(42), pad))
    got = tacs._acs_fused(
        *(torch.from_numpy(x.astype(np.int64) if x.dtype == np.int32
                           else x) for x in (src, dst, w, valid, keep)),
        pad, masks=jax_masks(pad)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(_betweenness_graphs()))
def test_betweenness_clustering_pagerank_assortativity_match_jax(name):
    adj = _betweenness_graphs()[name]
    a, valid = _pad(adj)
    ja, jv = jnp.asarray(a), jnp.asarray(valid)
    ta, tv = torch.from_numpy(a), torch.from_numpy(valid)
    for jfn, tfn, args in (
            (jacs._betweenness, tacs._betweenness, (16,)),
            (jacs._directed_clustering, tacs._directed_clustering, ()),
            (jacs._pagerank, tacs._pagerank, ()),
            (jacs._assortativity, tacs._assortativity, ())):
        np.testing.assert_allclose(tfn(ta, tv, *args).numpy(),
                                   np.asarray(jfn(ja, jv, *args)),
                                   rtol=TOL, atol=TOL, err_msg=tfn.__name__)
    und = np.minimum(a + a.T, 1.0)
    np.testing.assert_array_equal(
        tacs._distance_matrix(torch.from_numpy(und), tv, 128).numpy(),
        np.asarray(jacs._distance_matrix(jnp.asarray(und), jv, 128)))


def test_ba926_metrics_equal_jax_under_auto():
    """bench.py's 926-node graph through ``_compute``: ``auto`` resolves
    to the device sweep in both packages; every metric but Louvain
    equal."""
    adj = _ba_adj()
    names = [f"n{i}" for i in range(926)]
    out = {}
    for name, mod, cfg in (("jax", jacs, JConfig()), ("port", tacs,
                                                       TConfig())):
        acs = mod.ACSAutomata(_Nodes(926), cfg)
        backend = "xla" if 926 >= mod._AUTO_XLA_MIN_NODES else "networkx"
        out[name] = acs._compute(names, adj, backend)
    assert out["port"]["node_count"] == 926
    _assert_metrics_equal(out["port"], out["jax"])


@pytest.mark.parametrize("graph", ["planted", "caveman", "erdos", "ba926"])
def test_louvain_with_jax_masks_equals_jax(graph):
    """Fed the masks JAX draws, the port's ``_louvain`` gives JAX's labels,
    community count and modularity (within 1e-5)."""
    G = {"planted": lambda: nx.planted_partition_graph(8, 25, 0.3, 0.01,
                                                      seed=2),
         "caveman": lambda: nx.relaxed_caveman_graph(10, 15, 0.1, seed=4),
         "erdos": lambda: nx.erdos_renyi_graph(150, 0.06, seed=1),
         "ba926": lambda: nx.barabasi_albert_graph(926, 2, seed=0)}[graph]()
    adj = nx.to_numpy_array(G).astype(np.float32)
    a, valid = _pad(adj, jacs._pad_dim(adj.shape[0]))
    jl, jq, jk = jacs._louvain(jnp.asarray(a), jnp.asarray(valid),
                               jax.random.PRNGKey(42))
    tl, tq, tk = tacs._louvain(torch.from_numpy(a), torch.from_numpy(valid),
                               masks=jax_masks(a.shape[0]))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert float(tk) == float(jk)
    assert abs(float(tq) - float(jq)) <= TOL


def test_louvain_with_the_ports_generator_meets_the_parity_criteria():
    """``tests/test_acs.py::test_xla_louvain_modularity_parity`` on the
    port's own masks: the exact community count and >= 95 % of NetworkX's
    modularity on planted structure, >= 85 % on an Erdős–Rényi graph."""
    acs = tacs.ACSAutomata.__new__(tacs.ACSAutomata)
    for G, exact_k in [
            (nx.planted_partition_graph(8, 25, 0.3, 0.01, seed=2), 8),
            (nx.relaxed_caveman_graph(10, 15, 0.1, seed=4), 10)]:
        adj = nx.to_numpy_array(G).astype(np.float32)
        k_x, q_x = acs._louvain_xla(adj)
        q_nx = nx.community.modularity(
            G, nx.community.louvain_communities(G, seed=42))
        assert k_x == exact_k
        assert q_x >= 0.95 * q_nx, (q_x, q_nx)
    G = nx.erdos_renyi_graph(150, 0.06, seed=1)
    _, q_x = acs._louvain_xla(nx.to_numpy_array(G).astype(np.float32))
    q_nx = nx.community.modularity(
        G, nx.community.louvain_communities(G, seed=42))
    assert q_x >= 0.85 * q_nx


def test_louvain_masks_are_seeded_and_shaped():
    m = tacs.louvain_masks(200)
    assert m.shape == (3, 20, 200) and m.dtype == torch.bool
    assert torch.equal(m, tacs.louvain_masks(200))
    assert 0.4 < float(m.float().mean()) < 0.6
    with pytest.raises(ValueError):
        tacs._louvain(torch.zeros(128, 128), torch.ones(128),
                      masks=tacs.louvain_masks(64))


@pytest.mark.parametrize("n_nodes,want", [(95, "networkx"), (96, "xla"),
                                          (130, "xla")])
def test_auto_switches_to_the_device_sweep_at_96_nodes(monkeypatch, n_nodes,
                                                       want):
    seen = []
    real = tacs.ACSAutomata._compute

    def spy(self, names, adj, backend):
        seen.append(backend)
        return real(self, names, adj, backend)

    monkeypatch.setattr(tacs.ACSAutomata, "_compute", spy)
    s = _random_store(n_entities=n_nodes - 1, n_rels=8 * n_nodes, seed=5)
    m = tacs.ACSAutomata(s, TConfig(backend="auto")).update_metrics()
    assert tacs._AUTO_XLA_MIN_NODES == jacs._AUTO_XLA_MIN_NODES == 96
    assert m["node_count"] == n_nodes and seen == [want]
    assert "error" not in m


def test_xla_backend_runs_the_device_sweep():
    """``acs.backend: xla`` no longer raises; it reaches ``_acs_fused``."""
    calls = []
    real = tacs._acs_fused

    def spy(*args, **kw):
        calls.append(args[-1])
        return real(*args, **kw)

    s = _random_store(seed=1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tacs, "_acs_fused", spy)
        m = tacs.ACSAutomata(s, TConfig(backend="xla")).update_metrics()
    assert calls == [128] and "error" not in m and m["node_count"] == 41


@pytest.mark.parametrize("seed", [0, 1])
def test_device_sweep_matches_networkx(seed):
    """``tests/test_acs.py::test_xla_matches_networkx`` on the port: the
    device sweep against the port's NetworkX backend, with that test's
    tolerances."""
    s = _random_store(seed=seed)
    nx_m = tacs.ACSAutomata(s, TConfig(backend="networkx")).update_metrics()
    dev_m = tacs.ACSAutomata(s, TConfig(backend="xla")).update_metrics()
    for key, tol in [("global_efficiency", 1e-3), ("avg_path_length", 1e-3),
                     ("diameter_estimate", 0),
                     ("weakly_connected_components", 0),
                     ("largest_wcc_size", 0),
                     ("pagerank_top10_percent", 0.5)]:
        a, b = nx_m[key], dev_m[key]
        assert (a == b) if a is None or b is None else abs(a - b) <= tol, \
            (key, a, b)


def test_louvain_networkx_override_on_the_device_path():
    """``acs.louvain: networkx`` pins the exact NetworkX Louvain on the
    device path, as in the JAX package."""
    s = _random_store(seed=3)
    nx_m = tacs.ACSAutomata(s, TConfig(backend="networkx")).update_metrics()
    pinned = tacs.ACSAutomata(s, TConfig(backend="xla", louvain="networkx")
                              ).update_metrics()
    assert pinned["louvain_communities"] == nx_m["louvain_communities"]
    assert pinned["louvain_modularity"] == \
        pytest.approx(nx_m["louvain_modularity"], abs=1e-6)


@pytest.mark.parametrize("n,edges", [(2, [(0, 1)]), (150, [])])
def test_per_metric_device_path_equals_jax(n, edges):
    """Graphs that the fused sweep does not take (n < 3, or no edge) run
    the per-metric device functions in both packages."""
    adj = np.zeros((n, n), np.float32)
    for i, j in edges:
        adj[i, j] = 1.0
    names = [f"n{i}" for i in range(n)]
    want = jacs.ACSAutomata(_Nodes(n), JConfig())._compute(names, adj,
                                                           "xla")
    got = tacs.ACSAutomata(_Nodes(n), TConfig())._compute(names, adj, "xla")
    _assert_metrics_equal(got, want, skip=())
