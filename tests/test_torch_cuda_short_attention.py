"""The hand-written CUDA short-attention kernel (``csrc/short_attention.
cu``) against its plain PyTorch version, on the card.  Marked ``cuda``:
they skip on a host without one.  Run them there with
``python -m pytest tests/test_torch_cuda_short_attention.py``.

Tolerance (``ops/short_attention.py``): ``TOL_ABS + TOL_REL * |plain|``
(0.01 + 0.02 |plain|): both round the probabilities and the output to
bfloat16, in another summation order, so a probability that rounds the
other way moves the output by about one ulp.
"""
import numpy as np
import pytest
import torch

from vidgraph_tpu_torch.ops import short_attention as sa

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, h, n, hd, seed, dev, dtype=torch.bfloat16, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=(b, h, n, hd)) * scale).astype(
        np.float32)).to(dev, dtype) for _ in range(3)]


def _assert_close(q, k, v):
    got = sa.fused_short_attention(q, k, v)
    torch.cuda.synchronize()
    ref = sa.short_attention_ref(q, k, v)
    assert got.dtype == ref.dtype == torch.bfloat16
    assert got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    excess = err - (sa.TOL_ABS + sa.TOL_REL * ref.float().abs())
    assert float(excess.max()) <= 0, float(err.max())
    assert bool(torch.isfinite(got).all())


# the shapes of chip_smoke.py phase 10 (B 1, 5, 160 x 12 heads x N 50)
# and N 49, and others the kernel takes: N off a multiple of the 16-row
# strips, above one 64-key tile (N 70, and 197, ViT-B/16's tokens, in four
# tiles), the most it takes (256), a single token
@pytest.mark.parametrize("b,h,n", [(1, 12, 50), (5, 12, 50), (160, 12, 50),
                                   (5, 12, 49), (160, 12, 49), (1, 2, 5),
                                   (2, 4, 33), (2, 2, 70), (1, 2, 197),
                                   (1, 2, 256), (3, 2, 1)])
def test_kernel_matches_plain(dev, b, h, n):
    _assert_close(*_qkv(b, h, n, 64, b + n, dev))


@pytest.mark.parametrize("b,n", [(1, 50), (5, 50), (160, 50), (5, 49)])
def test_strided_views_of_one_product(dev, b, n):
    """The ViT's q, k, v: slices of one [b, n, 3d] product, transposed."""
    qkv = torch.randn(b, n, 3 * 768, device=dev, dtype=torch.bfloat16)
    q, k, v = (z.reshape(b, n, 12, 64).transpose(1, 2)
               for z in qkv.split(768, dim=-1))
    _assert_close(q, k, v)


def test_large_scores(dev):
    """Scores in the hundreds (q and k 4x the unit scale)."""
    q, k, _ = _qkv(2, 12, 50, 64, 1, dev, scale=4.0)
    _assert_close(q, k, _qkv(2, 12, 50, 64, 2, dev)[2])


def test_launch_counts_and_no_plain_calls(dev):
    q, k, v = _qkv(1, 2, 50, 64, 0, dev)
    sa.reset_counts()
    sa.fused_short_attention(q, k, v)
    assert sa.LAUNCHES == {"short_attention": 1} and sa.REF_CALLS == 0
    sa.fused_short_attention(q.cpu(), k.cpu(), v.cpu())
    assert sa.LAUNCHES == {"short_attention": 1} and sa.REF_CALLS == 1


@pytest.mark.parametrize("shape,dtype", [
    ((1, 2, 50, 32), torch.bfloat16),       # head dim 32
    ((1, 2, 50, 64), torch.float32),        # float32
    ((1, 2, 50, 64), torch.float16),        # fp16
    ((1, 2, 257, 64), torch.bfloat16),      # more than 256 tokens
    ((1, 3, 50, 64), torch.bfloat16)])      # odd heads
def test_kernel_rejects_what_it_cannot_take(dev, shape, dtype):
    q, k, v = _qkv(*shape, 0, dev, dtype)
    with pytest.raises(ValueError):
        sa.fused_short_attention(q, k, v)


def test_kernel_rejects_rows_off_16_bytes(dev):
    """The 16-byte copies need every row on 16 bytes: a view one element
    into its storage is refused."""
    x = torch.zeros(1 * 2 * 50 * 64 + 1, device=dev, dtype=torch.bfloat16)
    q = x[1:].view(1, 2, 50, 64)
    with pytest.raises(ValueError):
        sa.fused_short_attention(q, q, q)
