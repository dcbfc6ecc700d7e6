"""The hand-written CUDA w8a16 product (``csrc/q8_matmul.cu``) against its
plain PyTorch version, on the card.  Marked ``cuda``: they skip on a host
without one.  Run them there with
``python -m pytest tests/test_torch_cuda_q8_matmul.py``.

Tolerance (``ops/q8_matmul.py``): max |err| <= ``TOL_REL`` (1e-4) times
max |plain|.  Both sum exact products in float32 and differ in the order of
the K additions only.  Two runs of the kernel must give the same bits: the
partial sums of a cluster's ranks are added in rank order.  The bfloat16
output must be the float32 output's ``.to(bfloat16)``, bit for bit.
"""
import numpy as np
import pytest
import torch

from vidgraph_tpu_torch.models import quant8
from vidgraph_tpu_torch.ops import q8_matmul as q8

pytestmark = pytest.mark.cuda

# the block matrices of CaptionerConfig.large() and base(): (K, N)
SHAPES = [(2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048),
          (512, 1536), (512, 512), (512, 2048), (2048, 512)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(m, k, n, seed, dev, x_scale=1.0, zero_column=False):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.normal(size=(m, k)) * x_scale).astype(
        np.float32)).to(dev, torch.bfloat16)
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    if zero_column:
        w[:, 3] = 0.0
    wq = quant8.quantize_matrix(torch.from_numpy(w).to(dev))
    return x, wq.q, wq.s


def _assert_close(x, q, s, cluster=None):
    got = q8._cuda_q8_matmul(x, q, s, cluster=cluster)
    again = q8._cuda_q8_matmul(x, q, s, cluster=cluster)
    torch.cuda.synchronize()
    ref = q8.q8_matmul_ref(x, q, s)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again), "two runs differ"
    err = float((got - ref).abs().max())
    assert err <= q8.TOL_REL * float(ref.abs().max()), err
    return got


@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("m", [1, 4, 5, 8, 32, 33, 36, 40, 63, 64])
def test_kernel_matches_plain(dev, m, k, n):
    _assert_close(*_inputs(m, k, n, m + k + n, dev))


@pytest.mark.parametrize("m", [16, 17, 33, 48, 49])
def test_every_row_tile_count(dev, m):
    _assert_close(*_inputs(m, 512, 256, m, dev))


@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("cluster", range(1, 9))
def test_any_split_of_k(dev, k, n, cluster):
    """Every cluster size a shape allows (uneven splits, one 64-row tile a
    rank) against the plain version."""
    if cluster > k // q8.TILE_K:
        with pytest.raises(ValueError):
            q8.plan(8, k, n, cluster=cluster)
        return
    _assert_close(*_inputs(8, k, n, cluster + k, dev), cluster=cluster)


@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("m", [1, 8, 33, 64])
def test_bf16_output_is_the_float32_output_rounded(dev, m, k, n):
    x, q, s = _inputs(m, k, n, m + n, dev)
    f32 = q8.q8_matmul(x, q, s)
    got = q8.q8_matmul(x, q, s, torch.bfloat16)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == f32.shape
    assert torch.equal(got, f32.to(torch.bfloat16))


@pytest.mark.parametrize("x_off,q_off", [(8, 0), (0, 16), (24, 48)])
def test_inputs_at_other_aligned_offsets(dev, x_off, q_off):
    """x and q as views 16 bytes or more into larger buffers (x_off bf16
    elements, q_off int8 bytes): the tensor maps take any 16-byte aligned
    start."""
    m, k, n = 5, 2048, 2048
    x, q, s = _inputs(m, k, n, 11, dev)
    xb = torch.zeros(m * k + x_off, device=dev, dtype=torch.bfloat16)
    qb = torch.zeros(k * n + q_off, device=dev, dtype=torch.int8)
    xv = xb[x_off:].view(m, k)
    qv = qb[q_off:].view(k, n)
    xv.copy_(x)
    qv.copy_(q)
    assert xv.data_ptr() % 16 == 0 and qv.data_ptr() % 16 == 0
    assert xv.data_ptr() != x.data_ptr()
    got = _assert_close(xv, qv, s)
    assert torch.equal(got, q8.q8_matmul(x, q, s))


def test_zero_column_and_large_activations(dev):
    x, q, s = _inputs(8, 2048, 2048, 3, dev, x_scale=300.0,
                      zero_column=True)
    assert float(x.abs().max()) > 900 and float(s[3]) == np.float32(1e-8)
    got = _assert_close(x, q, s)
    assert not got[:, 3].any()


def test_float32_activations_are_rounded_to_bf16(dev):
    x, q, s = _inputs(8, 512, 512, 9, dev)
    xf = x.float() + 1e-4
    got = q8.q8_matmul(xf, q, s)
    torch.cuda.synchronize()
    assert torch.equal(got, q8.q8_matmul(xf.to(torch.bfloat16), q, s))


def test_counts_and_refusals(dev):
    """72 rows, once refused, are two launches (64 + 8 rows)."""
    x, q, s = _inputs(8, 512, 512, 1, dev)
    q8.reset_counts()
    q8.q8_matmul(x, q, s)
    q8._cuda_q8_matmul(x, q, s, cluster=4)
    assert q8.LAUNCHES["q8_matmul"] == 2 and q8.REF_CALLS == 0
    x72 = torch.cat([x] * 9)
    got = q8.q8_matmul(x72, q, s)                         # 72 rows
    torch.cuda.synchronize()
    assert torch.equal(got, torch.cat([q8.q8_matmul(x, q, s)] * 9))
    assert q8.LAUNCHES["q8_matmul"] == 2 + 2 + 1
    with pytest.raises(ValueError):
        q8._cuda_q8_matmul(x, q, s, cluster=9)               # 8 tiles only
    with pytest.raises(ValueError):
        q8.q8_matmul(x, q.t(), s)                         # not contiguous
    with pytest.raises(ValueError):
        q8.q8_matmul(x.cpu(), q, s)
    assert q8.LAUNCHES["q8_matmul"] == 5 and q8.REF_CALLS == 0


@pytest.mark.parametrize("k,n", [(2048, 8192), (512, 1536), (8192, 2048)])
@pytest.mark.parametrize("m", [65, 128, 200, 1000])
def test_rows_past_64_take_slabs(dev, m, k, n):
    """M > 64 (what the TPU kernel pads to a multiple of 16): one launch a
    64-row slab, each slab the bits of its rows' own product, within the
    tolerance of the plain version; the bfloat16 output is the float32's
    rounding."""
    x, q, s = _inputs(m, k, n, m + k, dev)
    q8.reset_counts()
    got = _assert_close(x, q, s)
    assert q8.LAUNCHES["q8_matmul"] == 2 * len(q8.slabs(m)) \
        == 2 * -(-m // 64)
    for r0, rows in q8.slabs(m):
        assert torch.equal(got[r0:r0 + rows],
                           q8.q8_matmul(x[r0:r0 + rows].contiguous(), q, s))
    bf16 = q8.q8_matmul(x, q, s, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(bf16, got.to(torch.bfloat16))


@pytest.mark.parametrize("lead,k,n,kernel", [
    ((8, 1), 2048, 6144, True),      # a decode step
    ((4, 9), 2048, 2048, True),      # a prefill of 36 rows
    ((8, 9), 2048, 2048, False),     # 72 rows: the a16 path
    ((8, 1), 2048, 259, False),      # head_w: the a16 path
])
def test_wdot_a16p_dispatch(dev, lead, k, n, kernel):
    """``wdot(a16p)`` on the card launches the kernel where the JAX
    package would, never the plain version, and stays within a bf16 ulp
    of ``a16``."""
    rng = np.random.default_rng(k + n)
    x = torch.from_numpy(rng.normal(size=(*lead, k)).astype(
        np.float32)).to(dev, torch.bfloat16)
    w = quant8.quantize_matrix(torch.from_numpy(
        (rng.normal(size=(k, n)) * 0.02).astype(np.float32)).to(dev))
    q8.reset_counts()
    got = quant8.wdot(x, w, torch.bfloat16, "a16p")
    assert q8.LAUNCHES["q8_matmul"] == int(kernel) and q8.REF_CALLS == 0
    if kernel:        # one launch, its bf16 output the float32's rounding
        f32 = q8.q8_matmul(x.reshape(-1, k), w.q, w.s)
        assert torch.equal(got.reshape(-1, n), f32.to(torch.bfloat16))
    ref = quant8.wdot(x, w, torch.bfloat16, "a16")
    assert got.dtype == torch.bfloat16 and got.shape == (*lead, n)
    err = (got.float() - ref.float()).abs()
    assert float((err - 0.02 * ref.float().abs() - 1e-3).max()) <= 0


@pytest.mark.parametrize("m,k,n", [(1, 2048, 259), (8, 2048, 6144),
                                   (40, 8192, 2048), (3, 100, 36)])
def test_a8_product_is_exact_on_the_card(dev, m, k, n):
    """``_int8_product`` (``torch._int_mm`` behind zero padding) against
    the CPU's int32 product, at extreme values."""
    rng = np.random.default_rng(m + n)
    xq = torch.from_numpy(rng.choice([-127, 127], size=(m, k)).astype(
        np.int8))
    q = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    ref = quant8._int8_product(xq, q)
    got = quant8._int8_product(xq.to(dev), q.to(dev))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), ref)
