"""The row-sharded embedding search of the port on 4 gloo ranks against
the JAX package's ``ShardedEmbeddingStore`` on the conftest's 8 virtual
CPU devices (a (4, 2) mesh: rows over 4).

Every case of ``tests/test_sharded_search.py`` runs on the port's (4, 1)
mesh and on a 3-rank mesh (the odd padding), plus a store of fewer live
rows than ranks.  One gloo group serves the module (``torch_parallel_
cases.search_cases``).  Criteria: ids equal to the JAX store's and to
the one-device store's, scores within 1e-5.
"""
from pathlib import Path

import numpy as np
import pytest

from vidgraph_tpu.parallel.sharded_search import ShardedEmbeddingStore as JSS
from vidgraph_tpu_torch.parallel.launch import run_ranks

TESTS = str(Path(__file__).parent)
TOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(5000, 64)).astype(np.float32)
    q = rng.normal(size=(3, 64)).astype(np.float32)
    rng7 = np.random.default_rng(7)
    pvecs = rng7.normal(size=(300, 48)).astype(np.float32)
    pq = rng7.normal(size=(4, 48)).astype(np.float32)
    gvecs = np.random.default_rng(1).normal(size=(1500, 8)).astype(
        np.float32)
    srng = np.random.default_rng(5)
    return {"matches_numpy": {"vecs": vecs, "q": q},
            "api_parity": {"ids": [f"c{i}" for i in range(300)],
                           "vecs": pvecs, "q": pq},
            "growth": {"vecs": gvecs},
            "small": {"vecs": srng.normal(size=(2, 16)).astype(np.float32),
                      "q": srng.normal(size=(2, 16)).astype(np.float32)}}


@pytest.fixture(scope="module")
def runs(cpu_mesh):
    inputs = _inputs()
    jax_side = {}
    inp = inputs["matches_numpy"]
    js = JSS(cpu_mesh, dim=64, capacity=1024, device_min_rows=0)
    js.add([f"i{i}" for i in range(5000)], inp["vecs"])
    jax_side["matches_numpy"] = js.search(inp["q"], k=5)
    inp = inputs["api_parity"]
    js = JSS(cpu_mesh, dim=48, device_min_rows=0)
    js.add(inp["ids"], inp["vecs"])
    js.add(["c5"], np.ones((1, 48), np.float32))
    jax_side["api_parity"] = (js.search(inp["q"], k=7, threshold=-1.0),
                              js.similarity_matrix(inp["q"]))
    inp = inputs["small"]
    js = JSS(cpu_mesh, dim=16, device_min_rows=0)
    js.add(["s0", "s1"], inp["vecs"])
    jax_side["small"] = js.search(inp["q"], k=5)
    port = run_ranks("torch_parallel_cases:search_cases", 4, (inputs,),
                     pythonpath=[TESTS])[0]
    return inputs, jax_side, port


WORLDS = ["w4", "w3"]


def _same_hits(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert [i for i, _ in g] == [i for i, _ in r]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in r],
                                   atol=TOL, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_search_matches_numpy_and_jax(runs, world):
    inputs, jax_side, port = runs
    res = port[world]["matches_numpy"]
    assert res["len"] == 5000
    assert res["data"] == int(world[1:])
    assert res["padded_rows"] % res["data"] == 0
    vn = inputs["matches_numpy"]["vecs"]
    vn = vn / np.linalg.norm(vn, axis=1, keepdims=True)
    q = inputs["matches_numpy"]["q"]
    ref = (q / np.linalg.norm(q, axis=1, keepdims=True)) @ vn.T
    for r in range(3):
        assert {int(i[1:]) for i, _ in res["hits"][r]} == \
            set(np.argsort(-ref[r])[:5])
    _same_hits(res["hits"], jax_side["matches_numpy"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_store_sharding_layout(runs, world):
    res = runs[2][world]["layout"]
    d = int(world[1:])
    padded = res["capacity"] + (-res["capacity"]) % d
    assert res["shard_rows"] * d == padded
    assert res["placements"] == ["Shard(dim=0)", "Replicate()"]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_empty_and_threshold(runs, world):
    empty, thresholded = runs[2][world]["empty_threshold"]
    assert empty == [[]]
    assert thresholded == [[]]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_api_parity_with_single_device_and_jax(runs, world):
    res = runs[2][world]["api_parity"]
    jhits, jsim = runs[1]["api_parity"]
    assert res["ids"][0] == res["ids"][1]
    np.testing.assert_allclose(res["vectors"][0], res["vectors"][1],
                               atol=1e-6)
    np.testing.assert_allclose(res["get"][0], res["get"][1])
    _same_hits(res["hits"][0], res["hits"][1])
    _same_hits(res["hits"][0], jhits)
    np.testing.assert_allclose(res["sim"][0], res["sim"][1], atol=TOL)
    np.testing.assert_allclose(res["sim"][0], jsim, atol=TOL)
    assert res["rebuilt"][0] == res["ids"][0]
    np.testing.assert_allclose(res["rebuilt"][1], res["vectors"][0],
                               atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_growth_keeps_divisible_mirror(runs, world):
    res = runs[2][world]["growth"]
    assert res["capacity"] >= 1500
    assert res["padded_rows"] % int(world[1:]) == 0
    assert res["hit"][0][0][0] == "g42"


@pytest.mark.parametrize("world", WORLDS)
def test_fewer_rows_than_ranks(runs, world):
    """Ranks whose shard lies past the count add -1e30 slots and no ids:
    k = 5 over 2 rows gives the 2 rows, as on one device and in JAX."""
    sharded, plain, sim = runs[2][world]["small"]
    _same_hits(sharded, plain)
    _same_hits(sharded, runs[1]["small"])
    assert all(len(row) == 2 for row in sharded)
    assert sim.shape == (2, 2)


def test_mesh_builders_at_a_world_of_four(runs):
    """``host_cpu_mesh(4)`` is JAX's (2, 2); every rank's
    ``single_device_mesh`` is (1, 1); a model axis that does not divide
    the world falls back as ``_factor`` says."""
    import vidgraph_tpu.parallel.mesh as jmesh

    assert runs[2]["builders"] == {
        "host_cpu_mesh": (2, 2), "single_device_mesh": (1, 1),
        "model_axis_3": jmesh._factor(4, 3)}


def test_the_ranks_imported_no_jax():
    """The launcher fails a rank that imported jax; the cases module
    imports torch and the port only."""
    src = Path(TESTS, "torch_parallel_cases.py").read_text()
    assert "import jax" not in src and "vidgraph_tpu." not in src
