"""The port's EmbeddingStore against the JAX package's, fed the same adds.

The JAX store runs searches below 8192 rows as host BLAS and above it on
its device path; both are compared (``device_min_rows`` 8192 and 0).  The
port takes the JAX constructor's keywords (``dtype``, ``device_min_rows``)
with a float32 or bfloat16 mirror.  The
port runs every size through ``ops/topk_cosine`` (here its plain version).
Scores within 1e-5; ids equal wherever scores are more than 1e-5 apart.
"""
import os

os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.memory.embedding_store import \
    EmbeddingStore as JaxStore  # noqa: E402
from vidgraph_tpu_torch.convert import store_from_jax_state  # noqa: E402
from vidgraph_tpu_torch.memory.embedding_store import \
    EmbeddingStore  # noqa: E402

TOL = 1e-5


def _fill(stores, n, dim, seed, batch=97):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    ids = [f"c{i}" for i in range(n)]
    for s in range(0, n, batch):
        for st in stores:
            st.add(ids[s:s + batch], vecs[s:s + batch])
    # overwrite some rows in place, as re-ingest does
    over = rng.normal(size=(3, dim)).astype(np.float32)
    for st in stores:
        st.add(["c1", "c2", f"c{n - 1}"], over)
    return rng


def _assert_same_hits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=TOL, rtol=0)
        scores = [s for _, s in w]
        for j, ((gid, _), (wid, _)) in enumerate(zip(g, w)):
            prev_gap = scores[j - 1] - scores[j] if j else np.inf
            next_gap = scores[j] - scores[j + 1] if j + 1 < len(w) else np.inf
            if prev_gap > TOL and next_gap > TOL:
                assert gid == wid


@pytest.mark.parametrize("device_min_rows", [0, 8192])
@pytest.mark.parametrize("n", [5, 1500])
def test_search_and_similarity_match_jax(device_min_rows, n):
    dim = 64
    jax_store = JaxStore(dim=dim, device_min_rows=device_min_rows)
    store = EmbeddingStore(dim=dim)
    rng = _fill([jax_store, store], n, dim, seed=n)
    assert len(store) == len(jax_store) == n
    assert store.capacity == jax_store.capacity
    assert store.ids() == jax_store.ids()
    np.testing.assert_allclose(store.vectors(), jax_store.vectors(),
                               atol=1e-7, rtol=0)
    q = rng.normal(size=(11, dim)).astype(np.float32)
    for k in (1, 5, 64):
        _assert_same_hits(store.search(q, k), jax_store.search(q, k))
    _assert_same_hits(store.search(q, 5, threshold=0.1),
                      jax_store.search(q, 5, threshold=0.1))
    np.testing.assert_allclose(store.similarity_matrix(q),
                               jax_store.similarity_matrix(q),
                               atol=TOL, rtol=0)


def test_empty_store_like_jax():
    store, jax_store = EmbeddingStore(dim=8), JaxStore(dim=8)
    q = np.ones((2, 8), np.float32)
    assert store.search(q, 3) == jax_store.search(q, 3) == [[], []]
    assert store.similarity_matrix(q).shape == (2, 0)


def test_single_query_vector_and_get():
    store = EmbeddingStore(dim=4)
    store.add(["a", "b"], np.eye(4, dtype=np.float32)[:2] * 3.0)
    hits = store.search(np.array([0.0, 2.0, 0.0, 0.0], np.float32), k=2)
    assert hits[0][0][0] == "b" and abs(hits[0][0][1] - 1.0) < 1e-6
    np.testing.assert_allclose(store.get("a"), [1.0, 0, 0, 0])
    assert store.get("zzz") is None
    with pytest.raises(ValueError):
        store.add(["x"], np.zeros((1, 5), np.float32))


def test_store_from_jax_state_round_trips():
    jax_store = JaxStore(dim=32)
    rng = _fill([jax_store], 300, 32, seed=9)
    store = store_from_jax_state(jax_store.state_dict())
    state = store.state_dict()
    assert state["ids"] == jax_store.state_dict()["ids"]
    # from_state re-normalises the rows (in both packages): numpy's norm
    # may round the last bit differently with the buffer's alignment
    np.testing.assert_allclose(state["vectors"], jax_store.vectors(),
                               atol=1e-7, rtol=0)
    q = rng.normal(size=(4, 32)).astype(np.float32)
    _assert_same_hits(store.search(q, 7), jax_store.search(q, 7))
    again = EmbeddingStore.from_state(state)
    np.testing.assert_allclose(again.vectors(), store.vectors(),
                               atol=1e-7, rtol=0)
    assert again.device == torch.device("cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spelling", ["torch", "jax", "name"])
def test_jax_keywords_give_the_jax_results(dtype, spelling):
    """``EmbeddingStore(dim, capacity, dtype=..., device_min_rows=0)``, the
    JAX signature (``__graft_entry__.py`` calls it so), also through
    ``make_embedding_store``: the JAX store's results with a float32 or a
    bfloat16 mirror, the type given as torch's, JAX's or its name."""
    import jax.numpy as jnp

    from vidgraph_tpu_torch.parallel.serving import make_embedding_store

    given = {"torch": getattr(torch, dtype), "jax": getattr(jnp, dtype),
             "name": dtype}[spelling]
    dim = 32
    jax_store = JaxStore(dim, 2048, dtype=getattr(jnp, dtype),
                         device_min_rows=0)
    stores = [EmbeddingStore(dim, 2048, dtype=given, device_min_rows=0),
              make_embedding_store(dim, 2048, dtype=given,
                                   device_min_rows=0)]
    rng = _fill([jax_store, *stores], 700, dim, seed=3)
    q = rng.normal(size=(6, dim)).astype(np.float32)
    for store in stores:
        assert store.dtype == getattr(torch, dtype)
        assert store.device_min_rows == 0 and store.capacity == 2048
        _assert_same_hits(store.search(q, 9), jax_store.search(q, 9))
        np.testing.assert_allclose(store.similarity_matrix(q),
                                   jax_store.similarity_matrix(q),
                                   atol=TOL, rtol=0)


def test_jax_defaults_and_unsupported_mirror_types():
    store = EmbeddingStore(8)
    jax_store = JaxStore(8)
    assert store.device_min_rows == jax_store.device_min_rows == 8192
    assert store.dtype == torch.float32
    for bad in ("float16", torch.float64, np.int8):
        with pytest.raises(ValueError):
            EmbeddingStore(8, dtype=bad)
