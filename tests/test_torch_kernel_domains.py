"""Kernels 1 and 2 of the port take every input their TPU kernels take.

Kernel 1 (``ops/topk_cosine.py``): top-k at any k (k above the kernel's
lists is its dense scores and a stable sort), any width (a store whose
rows are kept zero-padded to a 16-byte stride) and a bfloat16 or float16
store, each held to the JAX package on the same numpy inputs: its
``cosine_topk``, ``_pallas_scores`` in interpret mode, ``EmbeddingStore``,
the HTTP server and the hybrid retriever.  Kernel 2
(``ops/preprocess.py``): the plain version at 4K frames against JAX's
``preprocess_frames``, and the kernel's plan for 4K and 8K frames (strips
of output columns, bands of any number of source rows) emulated from the
bytes each block stages.

Tolerances: scores within 1e-5 (float32 sums in another order); ids equal
wherever the scores on either side are more than 1e-5 apart, and equal
in order within every run of exactly equal scores (ties go to the lower
row, as ``lax.top_k`` breaks them).  The JAX store answers below
``device_min_rows`` with a host ``np.argsort``, which orders ties
arbitrarily: there ids are held where the scores are apart only.
Preprocessing: ``tests/test_torch_preprocess.py``'s tolerances.
"""
import asyncio
import os

os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.memory.embedding_store import \
    EmbeddingStore as JaxStore  # noqa: E402
from vidgraph_tpu.ops import preprocess as jpre  # noqa: E402
from vidgraph_tpu.ops import topk_cosine as jtc  # noqa: E402
from vidgraph_tpu_torch.memory.embedding_store import \
    EmbeddingStore  # noqa: E402
from vidgraph_tpu_torch.ops import preprocess as tpre  # noqa: E402
from vidgraph_tpu_torch.ops import topk_cosine as tc  # noqa: E402

TOL = 1e-5
LARGE_K = [65, 100, 300]


def _tied_inputs(b, n, d, seed):
    """Queries [b, d] and a store [n, d] of normalised rows, a third of
    them copies of scaled unit vectors: every copy of one scores the same
    single product in any order of summation, so each is an exact tie,
    many of them across the k-th place."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, d)).astype(np.float32)
    q[:, :4] += 3.0 * np.sign(q[:, :4])       # their ties rank high
    s = rng.normal(size=(n, d)).astype(np.float32)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    tied = rng.choice(n, n // 3, replace=False)
    axis = rng.integers(0, 6, len(tied))
    scale = rng.choice(np.float32([1.0, 0.5, -1.0]), len(tied))
    s[tied] = 0.0
    s[tied, axis] = scale
    return q, s


def _assert_same_topk(vals, idx, jvals, jidx, exact_ties=True):
    """Scores within TOL; ids equal where apart, and (``exact_ties``) in
    order within each run of equal reference scores."""
    k = vals.shape[1]
    np.testing.assert_allclose(vals, jvals[:, :k], atol=TOL, rtol=0)
    padded = np.concatenate([np.full((jvals.shape[0], 1), np.inf), jvals,
                             np.full((jvals.shape[0], 1), -np.inf)], axis=1)
    for j in range(k):
        apart = ((padded[:, j] - padded[:, j + 1] > TOL)
                 & (padded[:, j + 1] - padded[:, j + 2] > TOL))
        np.testing.assert_array_equal(idx[apart, j], jidx[apart, j])
        if exact_ties:
            tie = ((padded[:, j + 1] == padded[:, j])
                   | (padded[:, j + 1] == padded[:, j + 2]))
            np.testing.assert_array_equal(idx[tie, j], jidx[tie, j])


def _ties_in(jvals, k):
    return int((jvals[:, 1:k] == jvals[:, :k - 1]).sum())


# ------------------------------------------------------------- kernel 1: k
@pytest.mark.parametrize("k", LARGE_K)
def test_large_k_with_exact_ties_matches_jax(k):
    q, s = _tied_inputs(3, 1500, 64, seed=k)
    count = 1400
    jv, ji = jtc.cosine_topk(jnp.asarray(q), jnp.asarray(s), k + 1,
                             use_pallas=False, valid_count=count)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert _ties_in(jv, k) > k // 4
    vals, idx = tc.cosine_topk(torch.from_numpy(q), torch.from_numpy(s), k,
                               count=count)
    assert vals.shape == (3, k) and idx.dtype == torch.int32
    _assert_same_topk(vals.numpy(), idx.numpy(), jv, ji)
    assert (idx.numpy() < count).all()


def _fill(stores, n, dim, seed):
    q, s = _tied_inputs(4, n, dim, seed)
    ids = [f"c{i}" for i in range(n)]
    for st in stores:
        st.add(ids, s)
    return q


def _hits(store, q, k):
    out = store.search(q, k)
    return ([[sc for _, sc in row] for row in out],
            [[int(i[1:]) for i, _ in row] for row in out])


@pytest.mark.parametrize("device_min_rows", [0, 8192])
@pytest.mark.parametrize("k", LARGE_K)
def test_store_search_at_large_k_matches_jax(device_min_rows, k):
    """``EmbeddingStore.search(q, k)`` over 200 rows (k = 300 returns all
    200) against the JAX store: its device path (``device_min_rows=0``,
    ``lax.top_k``) and its host path."""
    dim = 64
    jax_store = JaxStore(dim=dim, device_min_rows=device_min_rows)
    store = EmbeddingStore(dim=dim)
    q = _fill([jax_store, store], 200, dim, seed=k + device_min_rows)
    jv, ji = _hits(jax_store, q, k)
    vals, idx = _hits(store, q, k)
    assert [len(r) for r in idx] == [min(k, 200)] * 4
    _assert_same_topk(np.asarray(vals), np.asarray(idx), np.asarray(jv),
                      np.asarray(ji), exact_ties=device_min_rows == 0)


def test_sharded_store_at_a_world_of_one_takes_large_k():
    """``ShardedEmbeddingStore`` on a (1, 1) mesh of this process (a gloo
    group of one): top-100 equal to the JAX store's device path."""
    from vidgraph_tpu_torch.parallel.mesh import build_mesh
    from vidgraph_tpu_torch.parallel.sharded_search import \
        ShardedEmbeddingStore

    dim = 64
    jax_store = JaxStore(dim=dim, device_min_rows=0)
    store = ShardedEmbeddingStore(build_mesh(model_axis=1), dim=dim,
                                  capacity=1024)
    q = _fill([jax_store, store], 200, dim, seed=11)
    jv, ji = _hits(jax_store, q, 100)
    vals, idx = _hits(store, q, 100)
    _assert_same_topk(np.asarray(vals), np.asarray(idx), np.asarray(jv),
                      np.asarray(ji))


def test_server_query_at_k_100_matches_jax():
    """``POST /v1/query {"k": 100}`` on a stream of 80 chunks, against the
    JAX server: equal JSON, scores within 1e-5."""
    from test_torch_server import _assert_same, _serve

    colours = ["red", "blue", "green", "white", "black"]
    objects = ["beaker", "flask", "balance", "glove", "pipette", "tray"]
    reqs = [("POST", "/v1/ingest",
             {"stream": "cam0", "chunk_id": f"cam0_{i}",
              "content": f"a {colours[i % 5]} {objects[i % 6]} number {i} "
                         f"on bench {i % 7}"}) for i in range(80)]
    reqs += [("POST", "/v1/query", {"stream": "cam0", "query": text,
                                    "k": 100})
             for text in ("a red beaker on the bench", "glove number 12")]
    ref, got = _serve("jax", reqs), _serve("torch", reqs)
    _assert_same(got, ref)
    assert [c for c, _ in got] == [200] * 82
    assert len(got[-1][1]["chunks"]) == len(ref[-1][1]["chunks"]) > 64


def _retrieval_graph(store_cls, persist_dir, embeddings, texts):
    store = store_cls("pool", persist_dir=persist_dir, dim=512)
    triplets = [{"head": "Person", "relation": "holds",
                 "tail": t.split()[2].capitalize(),
                 "source_chunks": [f"pool_{i}"]}
                for i, t in enumerate(texts)]
    store.add_batch_to_graph(
        triplets, [{"time": "00:00-00:04", "content": "x"}], 0,
        text_chunks=[{"id": f"pool_{i}", "content": t, "index": i,
                      "embedding": embeddings[i].tolist()}
                     for i, t in enumerate(texts)])
    return store


def test_retriever_with_rerank_pool_100_matches_jax(tmp_path):
    """A hybrid retriever with ``rerank_pool: 100`` over a graph of 90
    chunks fetches 100 chunk hits: its texts equal the JAX retriever's."""
    import vidgraph_tpu.core.config as jcfg
    import vidgraph_tpu.graph.embedded as jgraph
    import vidgraph_tpu.pipeline.retriever_hybrid as jret
    import vidgraph_tpu.services.embed_client as jembed
    import vidgraph_tpu.services.rerank_client as jrerank
    import vidgraph_tpu_torch.core.config as tcfg
    import vidgraph_tpu_torch.graph.embedded as tgraph
    import vidgraph_tpu_torch.pipeline.retriever_hybrid as tret
    import vidgraph_tpu_torch.services.embed_client as tembed
    import vidgraph_tpu_torch.services.rerank_client as trerank

    rng = np.random.default_rng(5)
    words = ["beaker", "flask", "balance", "glove", "pipette", "tray",
             "bottle", "notebook", "monitor"]
    texts = [f"The person holds {words[i % 9]} {rng.choice(words)} near "
             f"the {rng.choice(words)} at step {i}." for i in range(90)]
    queries = ["What does the person hold near the flask?",
               "Which step has the balance?", "Where is the glove?"]
    answers = {}
    for name, cfg_mod, graph_mod, ret, embed_mod, rerank_mod in (
            ("jax", jcfg, jgraph, jret, jembed, jrerank),
            ("port", tcfg, tgraph, tret, tembed, trerank)):
        cfg = cfg_mod.PipelineConfig()
        cfg.retrieval.entity_first = False
        cfg.retrieval.use_reranker = True
        cfg.retrieval.rerank_pool = 100
        embed = embed_mod.make_embed_client("tpu", dim=512)
        vecs = np.asarray(embed.embed(texts), np.float32)
        store = _retrieval_graph(graph_mod.EmbeddedGraphStore,
                                 str(tmp_path / name), vecs, texts)
        rerank = rerank_mod.make_rerank_client("tpu", embed_client=embed)
        retriever = ret.HybridRetriever(cfg.retrieval, store, embed, rerank,
                                        output_file=None)

        async def run():
            return [(await retriever.perform_hybrid_retrieval(q))[0]
                    for q in queries]
        answers[name] = asyncio.run(run())
        assert len(store.chunks) == 90
    assert all(answers["port"]) and answers["port"] == answers["jax"]


# --------------------------------------------------------- kernel 1: width
@pytest.mark.parametrize("d", [1000, 2560])
def test_wide_scores_match_the_pallas_kernel(d):
    """Scores at d 1000 and 2560 against ``_pallas_scores`` in interpret
    mode; a store kept zero-padded to the kernel's row stride (a view of
    its first d columns) scores as the unpadded one does."""
    rng = np.random.default_rng(d)
    q = rng.normal(size=(3, d)).astype(np.float32)
    s = rng.normal(size=(300, d)).astype(np.float32)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    want = np.asarray(jtc._pallas_scores(jnp.asarray(q), jnp.asarray(s),
                                         interpret=True))
    got = tc.cosine_scores(torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    rows = torch.zeros((300, d + 6))
    rows[:, :d] = torch.from_numpy(s)
    padded = rows[:, :d]
    assert padded.stride(0) == d + 6
    assert torch.equal(tc.cosine_scores(torch.from_numpy(q), padded), got)


@pytest.mark.parametrize("dim,dtype", [(510, torch.float32),
                                       (1000, torch.bfloat16),
                                       (2561, torch.float16)])
def test_store_mirror_rows_are_padded_to_the_kernel_stride(dim, dtype):
    """The mirror is a view of rows ``padded_width`` columns wide, zero
    past ``dim``; its hits equal an unpadded copy's."""
    store = EmbeddingStore(dim=dim, dtype=dtype)
    q = _fill([store], 100, dim, seed=dim)
    mirror = store._device_store()
    width = tc.padded_width(dim, dtype)
    assert mirror.shape[1] == dim and mirror.stride(0) == width
    assert (width * mirror.element_size()) % 16 == 0
    full = mirror.as_strided((mirror.shape[0], width), (width, 1))
    assert not full[:, dim:].any()
    vals, idx = tc.cosine_topk(torch.from_numpy(q), mirror, 10, count=100)
    rv, ri = tc.cosine_topk(torch.from_numpy(q), mirror.contiguous(), 10,
                            count=100)
    assert torch.equal(vals, rv) and torch.equal(idx, ri)


# ------------------------------------------------------ kernel 1: 16 bits
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16_bit_store_halves_the_mirror_and_matches_jax(dtype):
    """A bfloat16 or float16 store holds its mirror in that type (half the
    float32 mirror's bytes); its hits equal the JAX store's of that type
    (``device_min_rows=0``), its scores ``_pallas_scores`` on the 16-bit
    store in interpret mode."""
    dim = 64
    torch_dtype = getattr(torch, dtype)
    jax_store = JaxStore(dim=dim, dtype=getattr(jnp, dtype),
                         device_min_rows=0)
    store = EmbeddingStore(dim=dim, dtype=dtype, device_min_rows=0)
    wide = EmbeddingStore(dim=dim)
    q = _fill([jax_store, store, wide], 700, dim, seed=3)
    mirror = store._device_store()
    assert mirror.dtype == torch_dtype
    assert 2 * mirror.untyped_storage().nbytes() == \
        wide._device_store().untyped_storage().nbytes()
    for k in (5, 100):
        jv, ji = _hits(jax_store, q, k)
        vals, idx = _hits(store, q, k)
        _assert_same_topk(np.asarray(vals), np.asarray(idx), np.asarray(jv),
                          np.asarray(ji))
    store16 = jnp.asarray(mirror[:700].float().numpy()).astype(
        getattr(jnp, dtype))
    want = np.asarray(jtc._pallas_scores(jnp.asarray(q), store16,
                                         interpret=True))
    np.testing.assert_allclose(store.similarity_matrix(q), want, atol=TOL,
                               rtol=0)


# ------------------------------------------------------------ kernel 2
FOUR_K = [(2160, 3840), (3840, 2160)]
PLAN_SIZES = [(240, 320), (405, 720), (720, 1280), (1081, 1921),
              (2160, 3840), (3840, 2160), (4320, 7680), (7680, 4320)]
# emulated at 4K, whose plans take strips and bands of 78-155 source rows
# as 8K's do (8K's geometry: test_plan_fits_and_covers_every_output_once)
EMULATED = PLAN_SIZES[:6]


def _frame(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (1, h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("src", FOUR_K)
@pytest.mark.parametrize("fast", [True, False])
def test_plain_version_at_4k_matches_jax(src, fast):
    frame = _frame(*src, seed=src[0])
    got = tpre.preprocess_frames(torch.from_numpy(frame), 224, fast)
    want = np.asarray(jpre.preprocess_frames(jnp.asarray(frame), size=224,
                                             fast=fast)).astype(np.float32)
    tol = tpre.TOL_FAST if fast else 1e-4
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("src", PLAN_SIZES)
@pytest.mark.parametrize("fast", [True, False])
def test_plan_fits_and_covers_every_output_once(src, fast):
    """Every size up to 8K in either orientation: bands tile the output
    rows and strips the output columns once; a band's staged source rows
    hold every height tap of its rows and a strip's staged bytes every
    width tap of its columns, inside the frame; bulk copies stay 16-byte
    aligned; the block fits ``SMEM_MAX``.  Sizes whose full-width plan
    keeps within its limits keep it (240 x 320, 405 x 720, 720 x 1280);
    the others take strips."""
    h, w = src
    p = tpre.plan(h, w, 224, fast, 5)
    starts, _, th, tw, _, _ = tpre._host_tables(h, w, 224, fast)
    hs, ws = starts[:224], starts[224:]
    wc = 3 * w
    bf16_out = fast
    assert p.smem <= tpre.SMEM_MAX
    assert p.smem == tpre.smem_bytes(w, 224, p.rows, int(p.count.max()), th,
                                     tw, bf16_out, p.cols,
                                     int((p.hi - p.lo).max()))
    band_of = np.arange(224) // p.rows
    strip_of = np.arange(224) // p.cols
    assert len(p.first) == band_of[-1] + 1 and len(p.lo) == strip_of[-1] + 1
    lo_row, n_rows = p.first[band_of], p.count[band_of]
    assert (lo_row <= hs).all() and (hs + th <= lo_row + n_rows).all()
    assert (p.first >= 0).all() and (p.first + p.count <= h).all()
    lo_b, hi_b = p.lo[strip_of], p.hi[strip_of]
    assert (lo_b <= 3 * ws).all() and (3 * (ws + tw) <= hi_b).all()
    assert (p.lo % 16 == 0).all() and (p.hi <= wc).all()
    assert ((p.hi % 16 == 0) | (p.hi == wc)).all()
    full = tpre.band_plan(h, w, 224, fast, 5)
    if full[2].max() <= tpre.MAX_BAND_SOURCE_ROWS and full[3] <= \
            tpre.SMEM_TARGET:
        assert p.cols == 224 and p.rows == full[0] and p.smem == full[3]
    else:
        assert p.cols < 224 and p.cols % tpre.STRIP_COLS == 0


@pytest.mark.parametrize("src", EMULATED)
@pytest.mark.parametrize("fast", [True, False])
def test_plan_emulated_reproduces_the_plain_version(src, fast):
    """The kernel's arithmetic, each block reading only what it stages
    (``test_plan_fits_and_covers_every_output_once`` holds every tap
    inside a band's source rows and a strip's bytes): the height pass
    takes each tap as fp16 terms (one in the fast mode, two in the exact
    mode), each byte as the half 1024 + b, float32 sums of their
    products, then takes off 1024 x the row's sum of the terms; its rows
    are rounded to bf16 in the fast mode.  The width pass sums its taps
    in float32, then the fast mode adds the bias to the bf16 sum and
    rounds again, the exact mode takes (sum - a) / b.  The result is the
    plain version's within its tolerances against the kernel
    (``TOL_FAST``, ``TOL_F32``): a 4K row sums up to 40 taps of 1024 + b
    in float32 (8K's 70 came 1.6e-5 from the plain version's matrix
    product in the exact mode)."""
    h, w = src
    frame = _frame(h, w, seed=h + w)
    p = tpre.plan(h, w, 224, fast, 5)
    starts, weights, th, tw, a, b = tpre._host_tables(h, w, 224, fast)
    hs = torch.from_numpy(starts[:224].astype(np.int64))
    ws = torch.from_numpy(starts[224:].astype(np.int64))
    wh = torch.from_numpy(weights[:224 * th].reshape(224, th))
    ww = torch.from_numpy(weights[224 * th:].reshape(3, 224, tw))
    x = torch.from_numpy(frame[0].reshape(h, -1))
    terms, rest = [], wh.clone()
    for _ in range(1 if fast else 2):
        terms.append(rest.half().float())
        rest = rest - terms[-1]
    acc = torch.zeros(224, x.shape[1])
    tap_sum = torch.zeros(224, 1)
    for term in terms:
        for t in range(th):
            acc += term[:, t, None] * (x[hs + t].float() + 1024).half().float()
            tap_sum += term[:, t, None]
    y = acc - tap_sum * 1024
    if fast:
        y = y.to(torch.bfloat16).float()
    y = y.view(224, w, 3)
    out = torch.zeros(224, 224, 3)
    for t in range(tw):
        out += ww[:, :, t].T * y[:, ws + t]
    if fast:
        out = (out.to(torch.bfloat16).float() + torch.from_numpy(a)).to(
            torch.bfloat16).float()
        tol = tpre.TOL_FAST
    else:
        out = (out - torch.from_numpy(a)) / torch.from_numpy(b)
        tol = tpre.TOL_F32
    ref = tpre.preprocess_frames(torch.from_numpy(frame), 224, fast)
    np.testing.assert_allclose(out.numpy(), ref[0].float().numpy(), rtol=0,
                               atol=tol)
