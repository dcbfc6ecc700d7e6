"""The port's int8 serving (``models/quant8.py``, ``ops/q8_matmul.py``)
against the JAX package's, on the CPU, on the same numpy inputs.

Tolerances:
* ``quantize_matrix``: ``q`` equal exactly and ``s`` equal exactly (the
  same float32 abs-max, division, round half to even and clip);
* ``wdot``: float32 inputs within 1e-5 of max |ref| (the same arithmetic in
  another summation order), bfloat16 inputs within 2e-2 of max |ref| (the
  two frameworks round the bfloat16 product at places one ulp apart);
* ``q8_matmul_ref`` against the Pallas kernel in interpret mode: within
  ``TOL_REL`` (1e-4) of max |ref|, the limit the CUDA kernel is held to;
* the quantised ``tiny`` tree (float32 compute), carried across by
  ``convert.captioner_params_from_jax``: ``forward`` logits within 1e-5
  and greedy tokens equal, in every mode.
"""
import dataclasses
import os

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.models import captioner as jcap  # noqa: E402
from vidgraph_tpu.models import quant8 as jq8  # noqa: E402
from vidgraph_tpu.ops.q8_matmul import q8_matmul as jax_q8_matmul  # noqa: E402
from vidgraph_tpu_torch.convert import captioner_params_from_jax  # noqa: E402
from vidgraph_tpu_torch.models import captioner as tcap  # noqa: E402
from vidgraph_tpu_torch.models import quant8 as tq8  # noqa: E402
from vidgraph_tpu_torch.ops import q8_matmul as q8_op  # noqa: E402

MODES = ("a16", "a8", "a16p")


def _matrix(shape, seed, zero_column=False):
    w = (np.random.default_rng(seed).normal(size=shape) * 0.05).astype(
        np.float32)
    if zero_column:
        w[..., 1] = 0.0
    return w


# ---------------------------------------------------------- quantize_matrix
@pytest.mark.parametrize("shape,zero_column", [
    ((64, 32), False), ((64, 32), True), ((3, 16, 24), False),
    ((2, 3, 8, 5), True)])
def test_quantize_matrix_equals_jax(shape, zero_column):
    w = _matrix(shape, sum(shape), zero_column)
    ref = jq8.quantize_matrix(jnp.asarray(w))
    got = tq8.quantize_matrix(torch.from_numpy(w))
    assert tq8.is_q8(got) and got.shape == tuple(shape)
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(ref.s))
    if zero_column:
        assert float(got.s[1]) == np.float32(1e-8)
        assert not got.q[..., 1].any()


def test_quantize_matrix_of_bf16_weights():
    w = torch.from_numpy(_matrix((48, 40), 5)).to(torch.bfloat16)
    ref = jq8.quantize_matrix(jnp.asarray(w.float().numpy()).astype(
        jnp.bfloat16))
    got = tq8.quantize_matrix(w)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(ref.s))


def test_q8_to_and_repr():
    w = tq8.quantize_matrix(torch.ones(8, 4))
    moved = w.to(torch.device("cpu"))
    assert tq8.is_q8(moved) and moved.shape == (8, 4)
    assert "Q8(q=(8, 4), s=(4,))" == repr(moved)
    assert not tq8.is_q8(torch.ones(2, 2))


# --------------------------------------------------------------------- wdot
_DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
           "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("lead", [(4,), (2, 3)])
def test_wdot_equals_jax(mode, dtype, lead):
    tdt, jdt, tol = _DTYPES[dtype]
    rng = np.random.default_rng(len(lead) + len(mode))
    x = rng.normal(size=(*lead, 128)).astype(np.float32)
    w = _matrix((128, 256), 7)
    jw = jq8.quantize_matrix(jnp.asarray(w))
    tw = tq8.quantize_matrix(torch.from_numpy(w))
    ref = np.asarray(jq8.wdot(jnp.asarray(x).astype(jdt), jw, jdt, mode)
                     .astype(jnp.float32))
    got = tq8.wdot(torch.from_numpy(x).to(tdt), tw, tdt, mode)
    assert got.dtype == tdt and got.shape == (*lead, 256)
    err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= tol, (mode, dtype, err)


def test_wdot_float_weights_pass_through():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    w = torch.from_numpy(_matrix((64, 32), 1))
    for mode in MODES:
        assert torch.equal(tq8.wdot(x, w, torch.float32, mode), x @ w)


def test_wdot_close_to_the_float_product():
    """The JAX package's own bound (tests/test_quant8.py): within 3 % of
    the float product's largest entry, in every mode."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    w = torch.from_numpy(_matrix((64, 32), 1))
    ref = x @ w
    for mode in MODES:
        got = tq8.wdot(x, tq8.quantize_matrix(w), torch.float32, mode)
        assert float((got - ref).abs().max() / ref.abs().max()) < 0.03, mode


def test_a8_sums_are_exact_past_2_to_the_24():
    """K = 8192 rows of +-127 reach |sum| = 1.3e8: the int32 sum must not
    round where a float32 sum would."""
    k = 8192
    xq = torch.full((1, k), 127, dtype=torch.int8)
    q = torch.full((k, 2), 127, dtype=torch.int8)
    q[-1, 1] = 126
    got = tq8._int8_product(xq, q)
    assert got.dtype == torch.int32
    assert got.tolist() == [[127 * 127 * k, 127 * 127 * k - 127]]


def test_a16p_takes_the_a16_path_on_the_cpu():
    """Off the card ``a16p`` is ``a16`` bit for bit, and the kernel's plain
    version serves nothing (as the JAX package off the TPU)."""
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(8, 256)).astype(np.float32)).to(torch.bfloat16)
    w = tq8.quantize_matrix(torch.from_numpy(_matrix((256, 384), 2)))
    q8_op.reset_counts()
    a16 = tq8.wdot(x, w, torch.bfloat16, "a16")
    a16p = tq8.wdot(x, w, torch.bfloat16, "a16p")
    assert torch.equal(a16, a16p)
    assert q8_op.REF_CALLS == 0 and q8_op.LAUNCHES["q8_matmul"] == 0


# ---------------------------------------------------------------- q8_matmul
def _kernel_inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = _matrix((k, n), seed + 1)
    s = (np.abs(w).max(0) / 127.0).astype(np.float32)
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return x, q, s


@pytest.mark.parametrize("m,k,n", [(8, 256, 384), (5, 512, 1536)])
def test_q8_matmul_ref_equals_the_pallas_kernel(m, k, n):
    x, q, s = _kernel_inputs(m, k, n, m)
    ref = np.asarray(jax_q8_matmul(jnp.asarray(x), jnp.asarray(q),
                                   jnp.asarray(s), interpret=True))
    q8_op.reset_counts()
    got = q8_op.q8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                          torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert q8_op.REF_CALLS == 1 and q8_op.LAUNCHES["q8_matmul"] == 0
    assert np.abs(got.numpy() - ref).max() <= q8_op.TOL_REL * np.abs(
        ref).max()
    assert torch.equal(got, q8_op.q8_matmul_ref(
        torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s)))


@pytest.mark.parametrize("k,n", [(100, 128), (128, 100), (200, 300)])
def test_q8_matmul_rejects_odd_shapes(k, n):
    x, q, s = _kernel_inputs(4, k, n, 3)
    with pytest.raises(ValueError, match="multiples of 128"):
        q8_op.q8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                        torch.from_numpy(s))
    with pytest.raises(ValueError):
        jax_q8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                      interpret=True)


def test_q8_matmul_rejects_mismatched_inputs():
    x, q, s = (torch.from_numpy(a) for a in _kernel_inputs(4, 128, 128, 4))
    with pytest.raises(ValueError):
        q8_op.q8_matmul(x[:, :64], q, s)
    with pytest.raises(ValueError):
        q8_op.q8_matmul(x, q.float(), s)
    with pytest.raises(ValueError):
        q8_op.q8_matmul(x, q, s[:64])


# the block matrices of CaptionerConfig.large() and base(), and the least
PLAN_SHAPES = [(2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048),
               (512, 1536), (512, 512), (512, 2048), (2048, 512), (128, 128)]


@pytest.mark.parametrize("k,n", PLAN_SHAPES)
@pytest.mark.parametrize("m", [1, 5, 8, 32, 64])
def test_plan_covers_every_tile_once(m, k, n):
    """``plan``'s partition: every (N tile, K tile) summed by exactly one
    block, at most ``MAX_CLUSTER`` blocks a cluster, no empty K range, the
    kernel's row widths; the K ranges are the kernel's own
    ``rank * T / cluster`` split; the cluster is the largest power of two
    within the card's SMs that leaves each rank ``MIN_RANK_TILES``
    tiles."""
    p = q8_op.plan(m, k, n)
    assert p.rows in (8, 16, 32, 64) and m <= p.rows and (
        p.rows == 8 or p.rows // 2 < m)
    assert (p.tile_n, p.tile_k) == (q8_op.TILE_N, q8_op.TILE_K)
    assert p.column_blocks * p.tile_n == n
    assert 1 <= p.cluster <= q8_op.MAX_CLUSTER
    assert len(p.k_ranges) == p.cluster
    covered = []
    for k0, k1 in p.k_ranges:
        assert k0 < k1 and k0 % p.tile_k == 0 and k1 % p.tile_k == 0
        covered += range(k0 // p.tile_k, k1 // p.tile_k)
    assert covered == list(range(k // p.tile_k))
    tiles = k // p.tile_k
    for r, (k0, _) in enumerate(p.k_ranges):
        assert k0 // p.tile_k == r * tiles // p.cluster
    blocks = p.column_blocks * p.cluster
    assert p.cluster & (p.cluster - 1) == 0
    assert p.cluster == 1 or tiles // p.cluster >= q8_op.MIN_RANK_TILES
    assert blocks <= 2 * q8_op.H100_SMS or p.cluster == 1
    if (2 * p.cluster <= q8_op.MAX_CLUSTER
            and tiles // (2 * p.cluster) >= q8_op.MIN_RANK_TILES):
        assert 2 * blocks > round(q8_op.H100_SMS / p.column_blocks) * \
            p.column_blocks      # a cluster twice as large would overshoot
    for c in range(1, min(q8_op.MAX_CLUSTER, tiles) + 1):
        assert q8_op.plan(m, k, n, cluster=c).cluster == c


@pytest.mark.parametrize("bad", [dict(m=0), dict(m=65), dict(k=192),
                                 dict(n=100), dict(cluster=9),
                                 dict(k=128, cluster=3)])
def test_plan_refuses_what_the_kernel_cannot_take(bad):
    args = dict(m=8, k=2048, n=2048, cluster=None)
    args.update(bad)
    with pytest.raises(ValueError):
        q8_op.plan(args["m"], args["k"], args["n"], cluster=args["cluster"])


@pytest.mark.parametrize("m,k,n", [(8, 256, 384), (5, 512, 1536)])
def test_bf16_output_is_the_float32_output_rounded(m, k, n):
    """The bfloat16 output of the plain version (and of ``q8_matmul`` on
    the CPU) is the float32 output's ``.to(bfloat16)``, bit for bit."""
    x, q, s = (torch.from_numpy(a) for a in _kernel_inputs(m, k, n, m + 1))
    f32 = q8_op.q8_matmul_ref(x, q, s)
    got = q8_op.q8_matmul_ref(x, q, s, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))
    q8_op.reset_counts()
    assert torch.equal(q8_op.q8_matmul(x, q, s, torch.bfloat16), got)
    assert q8_op.REF_CALLS == 1
    with pytest.raises(ValueError):
        q8_op.q8_matmul(x, q, s, torch.float16)


# ------------------------------------------------- the quantised captioner
@pytest.fixture(scope="module")
def setup():
    jcfg = jcap.CaptionerConfig.tiny()
    jparams = jcap.init_params(jcfg, seed=3)
    jq = jq8.quantize_captioner_params(jparams)
    tq = captioner_params_from_jax(jax.tree_util.tree_map(np.asarray, jq))
    tparams = captioner_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    toks = rng.integers(3, 250, (2, 16)).astype(np.int32)
    vis = rng.normal(size=(2, jcfg.num_vision_tokens, jcfg.vision_dim)
                     ).astype(np.float32)
    return jcfg, tcap.CaptionerConfig.tiny(), jparams, jq, tparams, tq, \
        toks, vis


def test_quantised_tree_crosses_bit_for_bit(setup):
    _, tcfg, jparams, jq, tparams, tq, _, _ = setup
    assert set(tq) == set(jq)
    assert tq8.is_q8(tq["head_w"])
    np.testing.assert_array_equal(tq["head_w"].q.numpy(),
                                  np.asarray(jq["head_w"].q))
    for jb, tb in zip(jq["blocks"], tq["blocks"]):
        assert set(tb) == set(jb)
        for key in tq8.BLOCK_KEYS:
            assert tq8.is_q8(tb[key]) and tb[key].q.dtype == torch.int8
            assert tb[key].s.dtype == torch.float32
            np.testing.assert_array_equal(tb[key].q.numpy(),
                                          np.asarray(jb[key].q))
            np.testing.assert_array_equal(tb[key].s.numpy(),
                                          np.asarray(jb[key].s))
        assert not tq8.is_q8(tb["ln1_scale"])


@pytest.mark.parametrize("head", [True, False])
def test_quantize_captioner_params_equals_jax(setup, head):
    """The port's quantiser on the float tree gives the JAX package's
    quantised tree, keeps the layout, and counts the same bytes."""
    _, _, jparams, _, tparams, _, _, _ = setup
    jq = jq8.quantize_captioner_params(jparams, head=head)
    tq = tq8.quantize_captioner_params(tparams, head=head)
    assert set(tq) == set(tparams) and tq8.is_q8(tq["head_w"]) == head
    for tb, jb, fb in zip(tq["blocks"], jq["blocks"], tparams["blocks"]):
        assert set(tb) == set(fb)
        for key in tq8.BLOCK_KEYS:
            assert tb[key].shape == fb[key].shape
            np.testing.assert_array_equal(tb[key].q.numpy(),
                                          np.asarray(jb[key].q))
            np.testing.assert_array_equal(tb[key].s.numpy(),
                                          np.asarray(jb[key].s))
        assert tb["qkv_b"] is fb["qkv_b"]
    assert tq8.tree_bytes(tq) == jq8.tree_bytes(jq)
    assert tq8.tree_bytes(tparams) == jq8.tree_bytes(jparams)
    if head:        # the JAX package's own bound (tests/test_quant8.py)
        assert tq8.tree_bytes(tparams) / tq8.tree_bytes(tq) > 1.9


@pytest.mark.parametrize("mode", MODES)
def test_forward_logits_equal_jax(setup, mode):
    jcfg, tcfg, jparams, jq, _, tq, toks, vis = setup
    jc = dataclasses.replace(jcfg, qmode=mode)
    tc = dataclasses.replace(tcfg, qmode=mode)
    ref = np.asarray(jcap.forward(jq, jc, jnp.asarray(vis),
                                  jnp.asarray(toks)))
    got = tcap.forward(tq, tc, torch.from_numpy(vis),
                       torch.from_numpy(toks).long()).numpy()
    assert np.abs(got - ref).max() <= 1e-5, mode
    flt = np.asarray(jcap.forward(jparams, jcfg, jnp.asarray(vis),
                                  jnp.asarray(toks))).ravel()
    cos = float(flt @ got.ravel()
                / (np.linalg.norm(flt) * np.linalg.norm(got)))
    assert cos > 0.999, (mode, cos)


@pytest.mark.parametrize("mode", MODES)
def test_generate_tokens_equal_jax(setup, mode):
    jcfg, tcfg, _, jq, _, tq, _, vis = setup
    ref = np.asarray(jcap.generate(
        jq, dataclasses.replace(jcfg, qmode=mode), jnp.asarray(vis),
        max_new=8))
    got = tcap.generate(tq, dataclasses.replace(tcfg, qmode=mode),
                        torch.from_numpy(vis), max_new=8)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mode", MODES)
def test_generate_from_tokens_equal_jax(setup, mode):
    """Ragged prompts (10 and 16 of 16 tokens)."""
    jcfg, tcfg, _, jq, _, tq, toks, _ = setup
    plen = np.asarray([10, 16], np.int32)
    ref = np.asarray(jcap.generate_from_tokens(
        jq, dataclasses.replace(jcfg, qmode=mode), jnp.asarray(toks),
        jnp.asarray(plen), max_new=8))
    got = tcap.generate_from_tokens(
        tq, dataclasses.replace(tcfg, qmode=mode), torch.from_numpy(toks),
        torch.from_numpy(plen), max_new=8)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_serving_params_pass_q8_leaves_through(setup):
    _, tcfg, _, _, _, tq, _, vis = setup
    cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    served = tcap.serving_params(tq, cfg)
    assert served["head_w"] is tq["head_w"]
    for sb, tb in zip(served["blocks"], tq["blocks"]):
        for key in tq8.BLOCK_KEYS:
            assert sb[key] is tb[key]
        assert sb["qkv_b"].dtype == torch.bfloat16
        assert sb["ln1_scale"].dtype == torch.float32
    toks = tcap.generate(served, cfg, torch.from_numpy(vis), max_new=4)
    assert toks.shape == (2, 4)


def test_large_config_and_quantize_params():
    large, jlarge = tcap.CaptionerConfig.large(), jcap.CaptionerConfig.large()
    assert (large.width, large.layers, large.heads, large.max_len,
            large.num_vision_tokens, large.vision_dim) == (
        jlarge.width, jlarge.layers, jlarge.heads, jlarge.max_len,
        jlarge.num_vision_tokens, jlarge.vision_dim) == (2048, 24, 16, 1024,
                                                         8, 512)
    assert large.num_params == jlarge.num_params
    assert large.dtype == torch.bfloat16 and large.qmode == "a16"
    params = tcap.init_params(tcap.CaptionerConfig.tiny())
    cast = tcap.quantize_params(params)
    ref = jcap.quantize_params(jcap.init_params(jcap.CaptionerConfig.tiny()))
    assert cast["tok_emb"].dtype == torch.bfloat16
    for cb, jb in zip(cast["blocks"], ref["blocks"]):
        for key, leaf in cb.items():
            want = torch.bfloat16 if jb[key].dtype == jnp.bfloat16 \
                else torch.float32
            assert leaf.dtype == want, key
    q = tq8.quantize_captioner_params(params)
    assert tcap.quantize_params(q)["blocks"][0]["qkv_w"] is \
        q["blocks"][0]["qkv_w"]
