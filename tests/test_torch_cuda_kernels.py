"""The hand-written CUDA cosine top-k kernels (``cosine_score_tile`` and
``cosine_select``) against their plain PyTorch versions, on the card.
Marked ``cuda``: they skip on a host without one.  Run them there with
``python -m pytest tests/test_torch_cuda_kernels.py``.

Tolerances (every store type: the plain version upcasts a 16-bit store to
float32 as the kernel does): scores within 1e-5 (float32 sums taken in
another order than cuBLAS takes them); indices equal wherever the
reference scores on either side are more than 1e-5 apart, since a
near-tie may swap.  The selection above the lists (k > 64) is held bit
for bit to ``select_ref`` on the same dense scores.
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


@pytest.mark.parametrize("b", [1, 16, 30, 33, 40])
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


@pytest.mark.parametrize("n", [1, 255, 257])
@pytest.mark.parametrize("full", [False, True])
def test_stores_shorter_than_a_stage_or_off_the_tile(dev, n, full):
    """A store shorter than one ring stage (256 rows) or one row past it,
    with nothing or everything counted: top-k and dense scores."""
    count = n if full else 0
    store = _store(n, 512, n + 11, dev)
    q = _queries(3, 512, n, dev)
    _assert_topk(q, store, 5, count)
    got = tc.cosine_scores(q, store, count=count)
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        got.cpu().numpy(), tc.cosine_scores_ref(q, store, count).cpu().numpy(),
        atol=TOL, rtol=0)


def test_more_tiles_than_persistent_blocks(dev):
    """391 tiles of 256 rows over the card's SMs: every block walks a
    segment of several tiles."""
    n = 100_000
    tiles = -(-n // tc._build.library().cosine_tile_rows())
    assert tc.segment_tiles(n, dev) > 1 and tiles > torch.cuda. \
        get_device_properties(dev).multi_processor_count
    store = _store(n, 512, 12, dev)
    for b in (1, 16):
        _assert_topk(_queries(b, 512, 12, dev), store, 5, 99_000)


@pytest.mark.parametrize("d", [4, 64, 2048])
@pytest.mark.parametrize("b", [40, 70])
def test_batches_split_across_launches(dev, d, b):
    """B beyond one launch (32 queries, 8 at d = 2048): top-k and dense."""
    store = _store(2000, d, d + b, dev)
    q = _queries(b, d, d + b, dev)
    _assert_topk(q, store, 5, 1900)
    got = tc.cosine_scores(q, store, count=1900)
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        got.cpu().numpy(), tc.cosine_scores_ref(q, store, 1900).cpu().numpy(),
        atol=TOL, rtol=0)


def test_ties_across_tile_segment_and_stage_boundaries(dev):
    """One row copied to both sides of a tile boundary (255, 256), of a
    segment boundary and into later tiles: its copies score the same bits
    and come out in ascending row order, in the partials and the merge."""
    n = 100_000
    store = _store(n, 512, 13, dev)
    seg = tc.segment_rows(n, dev)
    dup = sorted({10, 255, 256, 257, seg - 1, seg, seg + 1, 2 * seg + 100,
                  n - 1})
    store[dup] = store[dup[0]].clone()
    q = store[dup[0]].view(1, -1) * torch.tensor([[1.0], [2.0], [0.5]],
                                                  device=dev)
    k = len(dup) + 2
    vals, idx = tc.cosine_topk(q, store, k, count=n)
    torch.cuda.synchronize()
    assert idx[:, :len(dup)].cpu().tolist() == [dup] * 3
    assert bool((vals[:, :len(dup)] == vals[:, :1]).all())
    pv, pi = tc.topk_partials(q, store, k, n)
    rv, ri = tc.topk_partials_ref(q, store, k, n, seg)
    torch.cuda.synchronize()
    top = pv[:, :, :2] > 0.5
    assert torch.equal(pi[:, :, :2][top], ri[:, :, :2][top])


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
                                         (1, 200_000, 64, 200_000),
                                         (33, 100_000, 5, 99_000),
                                         (40, 5000, 64, 100)])
def test_each_stage_matches_its_plain_version(dev, b, n, k, count):
    """One launch's tile pass (its lists, read from its scratch) against
    ``topk_partials_ref``, and its last block's merge of those lists
    against ``topk_merge_ref`` on them, bit for bit."""
    store = _store(n, 512, 6, dev)
    q = _queries(b, 512, 6, dev)
    vals, idx, pv, pi = tc.topk_lists(q, store, k, count)
    torch.cuda.synchronize()
    tile = tc.segment_rows(n, dev)
    rv, ri = tc.topk_partials_ref(q, store, k, count, tile)
    np.testing.assert_array_equal(pv.isinf().cpu().numpy(),
                                  rv.isinf().cpu().numpy())
    finite = ~rv.isinf()
    np.testing.assert_allclose(pv[finite].cpu().numpy(),
                               rv[finite].cpu().numpy(), atol=TOL, rtol=0)
    mv, mi = tc.topk_merge_ref(pv, pi, k)
    np.testing.assert_array_equal(vals.cpu().numpy(), mv.cpu().numpy())
    np.testing.assert_array_equal(idx.cpu().numpy(), mi.cpu().numpy())


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("k", [5, 32, 33, 64])
def test_merge_when_many_entries_pass(dev, b, k):
    """Scores rising along the store: the best lists' entries all beat
    the k-th best head, so past 1,024 entries pass the last block's
    threshold at k 64 and it merges in rounds; the result is the plain
    version's in every case."""
    n = 100_000
    a = np.linspace(-0.9, 0.9, n, dtype=np.float64)
    rows = np.zeros((n, 512), np.float32)
    rows[:, 0] = a
    rows[:, 1] = np.sqrt(1 - a * a)
    store = torch.from_numpy(rows).to(dev)
    q = torch.zeros((b, 512), device=dev)
    q[:, 0] = 1.0
    q[:, 1] = torch.linspace(0.0, 0.01, b, device=dev)
    vals, idx, pv, pi = tc.topk_lists(q, store, k, n)
    torch.cuda.synchronize()
    mv, mi = tc.topk_merge_ref(pv, pi, k)
    assert torch.equal(vals, mv) and torch.equal(idx, mi)
    _assert_topk(q, store, k, n)


def test_launch_counts_and_no_plain_calls(dev):
    """A search of k <= 64 is one launch up to a launch's 32 queries (two
    at 33); k > 64 is the dense pass and one selection."""
    store = _store(4096, 512, 4, dev)
    tc.reset_counts()
    tc.cosine_topk(_queries(2, 512, 4, dev), store, 5)
    tc.cosine_scores(_queries(2, 512, 4, dev), store)
    assert tc.LAUNCHES == {"score_topk": 1, "score_dense": 1, "select": 0}
    assert tc.REF_CALLS == 0
    for b, launches in ((1, 1), (16, 1), (32, 1), (33, 2)):
        tc.reset_counts()
        tc.cosine_topk(_queries(b, 512, b, dev), store, 64)
        assert tc.LAUNCHES == {"score_topk": launches, "score_dense": 0,
                               "select": 0}, (b, tc.LAUNCHES)
    tc.reset_counts()
    tc.cosine_topk(_queries(16, 512, 4, dev), store, 100)
    assert tc.LAUNCHES == {"score_topk": 0, "score_dense": 1, "select": 1}
    assert tc.REF_CALLS == 0


def _reference_topk(q, store, k, count):
    return tc.cosine_topk_ref(q, store, k + 1, count=count)


def _assert_rows(vals, idx, rv, ri, k):
    """``_assert_topk``'s checks on results already computed."""
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    rv, ri = rv.cpu().numpy(), ri.cpu().numpy()
    np.testing.assert_allclose(vals, rv[:, :k], atol=TOL, rtol=0)
    padded = np.concatenate([np.full((rv.shape[0], 1), np.inf), rv,
                             np.full((rv.shape[0], 1), -np.inf)], axis=1)
    for j in range(k):
        apart = ((padded[:, j] - padded[:, j + 1] > TOL)
                 & (padded[:, j + 1] - padded[:, j + 2] > TOL))
        np.testing.assert_array_equal(idx[apart, j], ri[apart, j])


def test_counter_after_back_to_back_searches(dev):
    """1,000 searches of one query each, back to back on one stream: each
    launch's last block merges and leaves the counter at zero for the
    next, so every result is its own query's."""
    store = _store(20_000, 512, 21, dev)
    q = _queries(1000, 512, 21, dev)
    got = [tc.cosine_topk(q[i:i + 1], store, 5, count=19_500)
           for i in range(1000)]
    torch.cuda.synchronize()
    rv, ri = _reference_topk(q, store, 5, 19_500)
    _assert_rows(torch.cat([v for v, _ in got]),
                 torch.cat([i for _, i in got]), rv, ri, 5)


def test_counter_under_cuda_graph_replay(dev):
    """Searches captured into a CUDA graph: every replay, on new queries
    copied into the captured input, gives those queries' top-k."""
    store = _store(50_000, 512, 22, dev)
    q_in = _queries(16, 512, 22, dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tc.cosine_topk(q_in, store, 5, count=49_000)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [tc.cosine_topk(q_in[:b], store, 5, count=49_000)
                for b in (1, 16, 3)]
    for r in range(8):
        q_in.copy_(_queries(16, 512, 100 + r, dev))
        graph.replay()
        torch.cuda.synchronize()
        for (vals, idx), b in zip(outs, (1, 16, 3)):
            rv, ri = _reference_topk(q_in[:b], store, 5, 49_000)
            _assert_rows(vals, idx, rv, ri, 5)


def test_counters_of_two_streams(dev):
    """Searches on two streams at once: each stream has a counter of its
    own, so neither launch's last block merges the other's lists."""
    store = _store(100_000, 512, 23, dev)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    qs = [_queries(16, 512, 23 + i, dev) for i in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(50):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(tc.cosine_topk(qs[i], store, 5, count=99_000))
    torch.cuda.synchronize()
    assert len({tc._counter_slot(dev.index or 0, st.cuda_stream)
                for st in streams}) == 2
    for i in range(2):
        rv, ri = _reference_topk(qs[i], store, 5, 99_000)
        for vals, idx in outs[i]:
            _assert_rows(vals, idx, rv, ri, 5)


def test_kernel_rejects_what_it_cannot_take(dev):
    store = _store(100, 512, 5, dev)
    q = _queries(2, 512, 5, dev)
    with pytest.raises(ValueError):
        tc.cosine_topk(q.double(), store.double(), 5)
    with pytest.raises(ValueError):
        tc.cosine_topk(q, store.T.contiguous().T, 5)
    with pytest.raises(ValueError):
        tc.cosine_topk(q, store, -1)
    with pytest.raises(ValueError):
        tc.cosine_topk(q.cpu(), store, 5)
    with pytest.raises(ValueError):
        tc.topk_partials(q, store, tc.LIST_K + 1, 100)
    scores = tc.cosine_scores(q, store)
    for k in (0, 101):
        with pytest.raises(ValueError):
            tc.select_topk(scores, k)
    with pytest.raises(ValueError):
        tc.select_topk(scores.double(), 5)


@pytest.mark.parametrize("k", [65, 100, 256, 1000])
@pytest.mark.parametrize("b", [1, 16])
def test_k_above_the_lists_matches_plain(dev, b, k):
    """k past the kernel's lists (65, once refused): the dense scores and
    the selection kernel, with ties placed across tiles."""
    store = _store(50_000, 512, k, dev)
    dup = [3, 255, 256, 4000, 30_000, 49_999]
    store[dup] = store[7].clone()
    q = _queries(b, 512, k, dev)
    q[0] = store[7] * 2.0
    tc.reset_counts()
    _assert_topk(q, store, k, 49_999)
    assert tc.LAUNCHES == {"score_topk": 0, "score_dense": 1, "select": 1}
    vals, idx = tc.cosine_topk(q, store, k, count=50_000)
    torch.cuda.synchronize()
    assert idx[0, :7].tolist() == sorted([7, *dup])


@pytest.mark.parametrize("d", [1, 7, 510, 1000, 1001, 2560, 4096])
def test_any_width_matches_plain(dev, d):
    """Widths off a multiple of 4 (510, once refused) and past 2048: the
    store is copied into rows of a 16-byte stride, or given as such a
    view; top-k and dense scores."""
    store = _store(3000, d, d, dev)
    q = _queries(5, d, d, dev)
    _assert_topk(q, store, 5, 2900)
    rows = torch.zeros((3000, tc.padded_width(d, torch.float32)),
                       device=dev)
    rows[:, :d] = store
    got = tc.cosine_scores(q, rows[:, :d], count=2900)
    torch.cuda.synchronize()
    np.testing.assert_allclose(
        got.cpu().numpy(), tc.cosine_scores_ref(q, store, 2900).cpu().numpy(),
        atol=TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [512, 1000, 20])
@pytest.mark.parametrize("k", [5, 64, 100])
def test_16_bit_stores_match_plain(dev, dtype, d, k):
    """A bfloat16 or float16 store, read in its type and upcast: the plain
    version on a float32 copy of the rounded rows (the reference of
    ``_assert_topk`` upcasts as the kernel does)."""
    store = _store(20_000, d, d + k, dev).to(dtype)
    if d % 8:
        rows = torch.zeros((20_000, tc.padded_width(d, dtype)), dtype=dtype,
                           device=dev)
        rows[:, :d] = store
        store = rows[:, :d]
    _assert_topk(_queries(16, d, d, dev), store, k, 19_000)


def _assert_select_exact(scores, k):
    got = tc.select_topk(scores, k)
    torch.cuda.synchronize()
    ref = tc.select_ref(scores, k)
    assert got[0].shape == (scores.shape[0], k) and got[1].dtype == torch.int32
    assert torch.equal(got[0], ref[0]), "selected scores differ"
    assert torch.equal(got[1], ref[1]), "selected columns differ"


@pytest.mark.parametrize("k", [65, 100, 256, 1000, 2000, 20_000, 50_000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_selection_is_the_stable_sort(dev, k, dtype):
    """The selection against the stable descending sort of the same dense
    scores, bit for bit, at B 1 and 16: k up to a thread's best (1000),
    the radix select (2000), a scratch sort (20,000) and k = n; a store
    of each type, rows copied across tiles so that scores tie."""
    store = _store(50_000, 512, k, dev)
    store[[3, 255, 256, 4000, 30_000, 49_999]] = store[7].clone()
    store = store.to(dtype)
    q = _queries(16, 512, k, dev)
    q[0] = store[7].float()
    scores = tc.cosine_scores(q, store, count=49_990)
    for b in (1, 16):
        _assert_select_exact(scores[:b], k)


@pytest.mark.parametrize("k", [65, 1000, 3000])
@pytest.mark.parametrize("n", [70, 1023, 4099, 200_000])
def test_selection_on_equal_rows(dev, n, k):
    """Every score equal (all rows the same), and -0.0 beside +0.0: the
    first k columns in order, for rows that start off 16 bytes (n odd)."""
    k = min(k, n)
    _assert_select_exact(torch.full((3, n), 0.25, device=dev), k)
    zeros = torch.zeros((3, n), device=dev)
    zeros[:, ::3] = -0.0
    _assert_select_exact(zeros, k)


@pytest.mark.parametrize("tied", [False, True])
def test_selection_past_the_sampled_bound(dev, tied):
    """High scores all in the columns of 100 of the kernel's 1,024
    threads (columns 4t..4t+3 of each 4,096): the 200th best of the
    threads' bests lets ~19,500 entries through, past shared memory, so
    the radix select takes over; with the high scores equal the cut
    falls inside a tie and the column's bits decide."""
    n = 200_000
    rng = np.random.default_rng(24)
    scores = rng.uniform(-1, 0, size=(4, n)).astype(np.float32)
    high = (np.arange(n) // 4) % 1024 < 100
    scores[:, high] = 0.5 if tied else rng.uniform(
        0.1, 1, size=(4, int(high.sum())))
    scores = torch.from_numpy(scores).to(dev)
    for k in (200, 1000):
        _assert_select_exact(scores, k)
