"""The hand-written CUDA cosine top-k kernel against its plain PyTorch
version, on the card.  Marked ``cuda``: they skip on a host without one.
Run them there with ``python -m pytest tests/test_torch_cuda_kernels.py``.

Tolerances: scores within 1e-5 (float32 sums taken in another order than
cuBLAS takes them); indices equal wherever the reference scores on either
side are more than 1e-5 apart, since a near-tie may swap.
"""
import numpy as np
import pytest
import torch

from vidgraph_tpu_torch.ops import topk_cosine as tc

pytestmark = pytest.mark.cuda
TOL = 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _store(n, d, seed, dev):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(n, d)).astype(np.float32)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    return torch.from_numpy(s).to(dev)


def _queries(b, d, seed, dev):
    rng = np.random.default_rng(seed + 1)
    return torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)


def _assert_topk(q, store, k, count):
    vals, idx = tc.cosine_topk(q, store, k, count=count)
    torch.cuda.synchronize()
    rv, ri = tc.cosine_topk_ref(q, store, k + 1, count=count)
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    rv, ri = rv.cpu().numpy(), ri.cpu().numpy()
    kk = min(k, store.shape[0])
    assert vals.shape == (q.shape[0], k) and idx.dtype == np.int32
    np.testing.assert_allclose(vals[:, :kk], rv[:, :kk], atol=TOL, rtol=0)
    padded = np.concatenate([np.full((rv.shape[0], 1), np.inf), rv,
                             np.full((rv.shape[0], 1), -np.inf)], axis=1)
    for j in range(kk):
        apart = ((padded[:, j] - padded[:, j + 1] > TOL)
                 & (padded[:, j + 1] - padded[:, j + 2] > TOL))
        np.testing.assert_array_equal(idx[apart, j], ri[apart, j])
    valid = min(count, store.shape[0])
    assert not (vals[:, :kk] > -1e29)[idx[:, :kk] >= valid].any()


@pytest.mark.parametrize("b", [1, 16, 30, 40])
@pytest.mark.parametrize("k", [1, 5, 64])
def test_topk_matches_plain_at_store_scale(dev, b, k):
    store = _store(200_000, 512, 0, dev)
    _assert_topk(_queries(b, 512, b, dev), store, k, 199_937)


@pytest.mark.parametrize("n,count,k", [(5000, 3, 5), (5000, 100, 64),
                                       (7, 7, 5), (300, 0, 4),
                                       (1024, 1024, 64)])
def test_topk_edges(dev, n, count, k):
    _assert_topk(_queries(3, 512, n, dev), _store(n, 512, n, dev), k, count)


@pytest.mark.parametrize("d", [4, 64, 2048])
def test_topk_other_widths(dev, d):
    _assert_topk(_queries(5, d, d, dev), _store(3000, d, d, dev), 5, 2900)


@pytest.mark.parametrize("b", [1, 30, 70])
def test_dense_scores_match_plain(dev, b):
    store = _store(20_000, 512, 3, dev)
    q = _queries(b, 512, 3, dev)
    got = tc.cosine_scores(q, store, count=19_000)
    torch.cuda.synchronize()
    ref = tc.cosine_scores_ref(q, store, count=19_000)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("b,n,k,count", [(16, 200_000, 5, 199_937),
                                         (40, 5000, 64, 100)])
def test_each_stage_matches_its_plain_version(dev, b, n, k, count):
    store = _store(n, 512, 6, dev)
    q = _queries(b, 512, 6, dev)
    pv, pi = tc.topk_partials(q, store, k, count)
    torch.cuda.synchronize()
    tile = tc._build.library().cosine_tile_rows()
    rv, ri = tc.topk_partials_ref(q, store, k, count, tile)
    np.testing.assert_array_equal(pv.isinf().cpu().numpy(),
                                  rv.isinf().cpu().numpy())
    finite = ~rv.isinf()
    np.testing.assert_allclose(pv[finite].cpu().numpy(),
                               rv[finite].cpu().numpy(), atol=TOL, rtol=0)
    vals, idx = tc.topk_merge(pv, pi, k)
    mv, mi = tc.topk_merge_ref(pv, pi, k)
    np.testing.assert_array_equal(vals.cpu().numpy(), mv.cpu().numpy())
    np.testing.assert_array_equal(idx.cpu().numpy(), mi.cpu().numpy())


def test_launch_counts_and_no_plain_calls(dev):
    store = _store(4096, 512, 4, dev)
    tc.reset_counts()
    tc.cosine_topk(_queries(2, 512, 4, dev), store, 5)
    tc.cosine_scores(_queries(2, 512, 4, dev), store)
    assert tc.LAUNCHES == {"score_topk": 1, "score_dense": 1, "merge": 1}
    assert tc.REF_CALLS == 0


def test_kernel_rejects_what_it_cannot_take(dev):
    store = _store(100, 512, 5, dev)
    q = _queries(2, 512, 5, dev)
    with pytest.raises(ValueError):
        tc.cosine_topk(q.double(), store.double(), 5)
    with pytest.raises(ValueError):
        tc.cosine_topk(q[:, :510].contiguous(), store[:, :510].contiguous(), 5)
    with pytest.raises(ValueError):
        tc.cosine_topk(q, store.T.contiguous().T, 5)
    with pytest.raises(ValueError):
        tc.cosine_topk(q, store, 65)
    with pytest.raises(ValueError):
        tc.cosine_topk(q.cpu(), store, 5)
