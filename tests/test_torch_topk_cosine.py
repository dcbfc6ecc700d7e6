"""The port's cosine scoring and top-k (on the CPU: the kernel's plain
version) against the JAX package's, on the same inputs made with numpy.

JAX side: the Pallas kernel in interpret mode (``_pallas_scores``), and the
fused masked top-k through its plain jnp path (``cosine_topk(use_pallas=
False, valid_count=...)``), which above 65,536 rows takes the two-stage
per-tile top-k.  Tolerances: scores within 1e-5 (float32 sums in another
order); indices equal wherever the scores on either side are more than
1e-5 apart, since a near-tie may swap.
"""
import os

os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.ops import topk_cosine as jtc  # noqa: E402
from vidgraph_tpu_torch.ops import topk_cosine as tc  # noqa: E402

TOL = 1e-5


def _inputs(b, n, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, d)).astype(np.float32)
    s = rng.normal(size=(n, d)).astype(np.float32)
    s /= np.maximum(np.linalg.norm(s, axis=1, keepdims=True), 1e-12)
    return q, s


def _assert_topk_equal(vals, idx, jvals, jidx, k):
    """``jvals/jidx`` hold k+1 columns so the k-th gap is known."""
    np.testing.assert_allclose(vals, jvals[:, :k], atol=TOL, rtol=0)
    padded = np.concatenate([np.full((jvals.shape[0], 1), np.inf), jvals,
                             np.full((jvals.shape[0], 1), -np.inf)], axis=1)
    for j in range(k):
        apart = ((padded[:, j] - padded[:, j + 1] > TOL)
                 & (padded[:, j + 1] - padded[:, j + 2] > TOL))
        np.testing.assert_array_equal(idx[apart, j], jidx[apart, j])


@pytest.mark.parametrize("b,n,d", [(3, 256, 128), (8, 2048, 64),
                                   (13, 1024, 512)])
def test_scores_match_pallas_interpret(b, n, d):
    q, s = _inputs(b, n, d, seed=b)
    want = np.asarray(jtc._pallas_scores(jnp.asarray(q), jnp.asarray(s),
                                         interpret=True))
    got = tc.cosine_scores(torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (b, n)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("count", [0, 1, 700, 1000])
def test_masked_scores_match_jax(count):
    q, s = _inputs(5, 1000, 64, seed=count)
    valid = jnp.arange(1000) < count
    want = np.asarray(jtc.cosine_scores(jnp.asarray(q), jnp.asarray(s),
                                        valid=valid, use_pallas=False))
    got = tc.cosine_scores(torch.from_numpy(q), torch.from_numpy(s),
                           count=count).numpy()
    np.testing.assert_allclose(got[:, :count], want[:, :count], atol=TOL,
                               rtol=0)
    assert (got[:, count:] == np.float32(-1e30)).all()
    assert (want[:, count:] == got[:, count:]).all()


@pytest.mark.parametrize("b,n,d,k,count", [
    (5, 1000, 64, 5, 900),       # B not a multiple of 8
    (1, 300, 512, 1, 300),
    (7, 4096, 128, 64, 4000),    # the kernel's largest k
    (3, 70_000, 32, 10, 69_001),  # JAX two-stage top-k (>= 65,536 rows)
    (3, 5000, 64, 65, 4900),     # past the lists: the selection kernel's k
    (2, 20_000, 128, 100, 20_000),
    (2, 70_000, 32, 1000, 69_001),
])
def test_topk_matches_jax(b, n, d, k, count):
    q, s = _inputs(b, n, d, seed=n)
    jv, ji = jtc.cosine_topk(jnp.asarray(q), jnp.asarray(s), k + 1,
                             use_pallas=False, valid_count=count)
    vals, idx = tc.cosine_topk(torch.from_numpy(q), torch.from_numpy(s), k,
                               count=count)
    assert vals.shape == (b, k) and idx.dtype == torch.int32
    _assert_topk_equal(vals.numpy(), idx.numpy(), np.asarray(jv),
                       np.asarray(ji), k)
    assert (idx.numpy() < count).all()


@pytest.mark.parametrize("b,n,d,k,count,tile", [
    (5, 1000, 64, 5, 900, 256),
    (3, 70_000, 32, 10, 69_001, 256),
    (4, 50, 16, 6, 3, 8),         # k above the count: masked rows tie
    (2, 300, 8, 64, 300, 64),     # the kernel's largest k, one tile's worth
])
def test_two_stage_plain_versions_match_jax(b, n, d, k, count, tile):
    """The per-tile partials and their merge, as the two kernels split the
    top-k, give JAX's top-k."""
    q, s = _inputs(b, n, d, seed=n + k)
    jv, ji = jtc.cosine_topk(jnp.asarray(q), jnp.asarray(s), k + 1,
                             use_pallas=False, valid_count=count)
    pv, pi = tc.topk_partials_ref(torch.from_numpy(q), torch.from_numpy(s),
                                  k, count, tile)
    assert pv.shape == pi.shape == (b, -(-n // tile), k)
    assert ((pi == tc.NO_INDEX) == (pv == float("-inf"))).all()
    vals, idx = tc.topk_merge_ref(pv, pi, k)
    _assert_topk_equal(vals.numpy(), idx.numpy(), np.asarray(jv),
                       np.asarray(ji), k)
    assert (vals.numpy() == tc.cosine_topk_ref(
        torch.from_numpy(q), torch.from_numpy(s), k, count)[0].numpy()).all()


def test_k_above_count_returns_sentinels_like_jax():
    q, s = _inputs(4, 64, 16, seed=3)
    jv, ji = jtc.cosine_topk(jnp.asarray(q), jnp.asarray(s), 6,
                             use_pallas=False, valid_count=3)
    vals, idx = tc.cosine_topk(torch.from_numpy(q), torch.from_numpy(s), 6,
                               count=3)
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_allclose(vals.numpy()[:, :3], jv[:, :3], atol=TOL)
    assert (vals.numpy()[:, 3:] == np.float32(-1e30)).all()
    assert (jv[:, 3:] == vals.numpy()[:, 3:]).all()
    # masked rows tie at -1e30 and come back in ascending row order
    np.testing.assert_array_equal(idx.numpy()[:, 3:], ji[:, 3:])
    np.testing.assert_array_equal(idx.numpy()[:, 3:], [[3, 4, 5]] * 4)


def test_k_above_store_rows_pads_like_jax():
    q, s = _inputs(2, 3, 8, seed=4)
    jv, ji = jtc.cosine_topk(jnp.asarray(q), jnp.asarray(s), 5,
                             use_pallas=False)
    vals, idx = tc.cosine_topk(torch.from_numpy(q), torch.from_numpy(s), 5)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), atol=TOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_empty_store_like_jax():
    q = np.ones((2, 8), np.float32)
    s = np.zeros((0, 8), np.float32)
    jv, ji = jtc.cosine_topk(jnp.asarray(q), jnp.asarray(s), 3,
                             use_pallas=False)
    vals, idx = tc.cosine_topk(torch.from_numpy(q), torch.from_numpy(s), 3)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    assert tc.cosine_scores(torch.from_numpy(q),
                            torch.from_numpy(s)).shape == (2, 0)


def test_ties_go_to_the_lower_row():
    s = np.zeros((6, 4), np.float32)
    s[:, 0] = 1.0                    # six identical rows
    q = np.array([[1.0, 0, 0, 0]], np.float32)
    vals, idx = tc.cosine_topk(torch.from_numpy(q), torch.from_numpy(s), 4)
    np.testing.assert_array_equal(idx.numpy(), [[0, 1, 2, 3]])
    np.testing.assert_allclose(vals.numpy(), 1.0, atol=TOL)


def test_cpu_tensors_take_the_plain_version():
    q, s = _inputs(2, 100, 16, seed=5)
    tc.reset_counts()
    tc.cosine_topk(torch.from_numpy(q), torch.from_numpy(s), 5)
    tc.cosine_topk(torch.from_numpy(q), torch.from_numpy(s), 70)
    scores = tc.cosine_scores(torch.from_numpy(q), torch.from_numpy(s))
    tc.select_topk(scores, 70)
    assert tc.REF_CALLS == 4
    assert tc.LAUNCHES == {"score_topk": 0, "score_dense": 0, "select": 0}


def _tied_inputs(b, n, d, seed):
    """A store of one-hot rows on a few columns: each score is one
    product, so rows with the same hot column tie exactly in any order of
    summation, in either framework."""
    rng = np.random.default_rng(seed)
    s = np.eye(d, dtype=np.float32)[rng.integers(0, 4, size=n)]
    return rng.normal(size=(b, d)).astype(np.float32), s


@pytest.mark.parametrize("n,k,count", [
    (5000, 65, 5000), (5000, 100, 4000), (5000, 1000, 5000),
    (300, 250, 200),              # k past the count: the masked rows tie
    (70_000, 1000, 69_001),       # JAX two-stage top-k
])
def test_topk_with_exact_ties_matches_jax(n, k, count):
    """Thousands of rows at each of four exact scores: indices equal to
    JAX's everywhere, equal scores in ascending row order."""
    q, s = _tied_inputs(3, n, 16, seed=k)
    jv, ji = jtc.cosine_topk(jnp.asarray(q), jnp.asarray(s), k,
                             use_pallas=False, valid_count=count)
    vals, idx = tc.cosine_topk(torch.from_numpy(q), torch.from_numpy(s), k,
                               count=count)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


@pytest.mark.parametrize("k", [65, 100, 1000, 3000])
@pytest.mark.parametrize("tied", [False, True])
def test_select_ref_matches_lax_top_k(k, tied):
    """The selection's plain version against ``lax.top_k`` on the same
    score matrix: values and indices equal, bit for bit (masked rows and
    repeated scores included)."""
    rng = np.random.default_rng(k)
    scores = rng.normal(size=(4, 3000)).astype(np.float32)
    if tied:
        scores = np.round(scores * 4) / 4
    scores[:, 2500:] = np.float32(-1e30)
    jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
    vals, idx = tc.select_ref(torch.from_numpy(scores), k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    got = tc.select_topk(torch.from_numpy(scores), k)
    assert all(torch.equal(a, b) for a, b in zip(got, (vals, idx)))


@pytest.mark.parametrize("k", [0, 65])
def test_k_outside_the_kernel_bound_raises(k):
    """k = 0 and k = 65, once outside the kernel's bound, give JAX's
    results (empty lists at 0; above the kernel's lists, its dense scores
    and a stable sort); only a negative k raises, as in JAX."""
    q, s = _inputs(2, 100, 16, seed=6)
    jv, ji = jtc.cosine_topk(jnp.asarray(q), jnp.asarray(s), k,
                             use_pallas=False, valid_count=90)
    vals, idx = tc.cosine_topk(torch.from_numpy(q), torch.from_numpy(s), k,
                               count=90)
    assert vals.shape == idx.shape == np.asarray(jv).shape == (2, k)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    with pytest.raises(ValueError):
        tc.cosine_topk(torch.from_numpy(q), torch.from_numpy(s), -1)


def test_l2_normalize_matches_jax():
    x = np.random.default_rng(7).normal(size=(9, 33)).astype(np.float32)
    np.testing.assert_allclose(tc.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jtc.l2_normalize(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
