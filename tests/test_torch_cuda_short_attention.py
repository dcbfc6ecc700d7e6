"""The hand-written CUDA short-attention kernel (``csrc/short_attention.
cu``) against its plain PyTorch version, on the card.  Marked ``cuda``:
they skip on a host without one.  Run them there with
``python -m pytest tests/test_torch_cuda_short_attention.py``.

Tolerance (``ops/short_attention.py``): ``TOL_ABS + TOL_REL * |plain|``
(0.01 + 0.02 |plain|): both round the probabilities and the output to
bfloat16, in another summation order, so a probability that rounds the
other way moves the output by about one ulp.  The general route
(``attn_general_fwd`` in two passes) is held to ``sa.tolerance`` of the
input's type: that for bfloat16, float16's scaled by 2^-10 / 2^-7, and
1e-5 for float32.
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
    assert got.dtype == ref.dtype == v.dtype
    assert got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    tol_abs, tol_rel = sa.tolerance(v.dtype)
    excess = err - (tol_abs + tol_rel * ref.float().abs())
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
    one = {"short_attention": 1, "short_attention_general": 0}
    assert sa.LAUNCHES == one and sa.REF_CALLS == 0
    sa.fused_short_attention(q.cpu(), k.cpu(), v.cpu())
    assert sa.LAUNCHES == one and sa.REF_CALLS == 1


@pytest.mark.parametrize("shape,dtype", [
    ((1, 3, 50, 64), torch.bfloat16),       # odd heads
    ((1, 2, 50, 64), torch.int32)])         # not a float type
def test_kernel_rejects_what_it_cannot_take(dev, shape, dtype):
    """What ``_fused_kernel`` does not take either: an odd head count and
    integers.  (hd 32, float32, float16 and N 257 were refused here once;
    ``test_general_route_matches_plain`` computes them.)"""
    q, k, v = _qkv(*shape, 0, dev, torch.float32)
    q, k, v = (z.to(dtype) for z in (q, k, v))
    with pytest.raises(ValueError):
        sa.fused_short_attention(q, k, v)


def test_kernel_rejects_rows_off_16_bytes(dev):
    """The mma kernel's 16-byte copies need every row on 16 bytes: a view
    one element into its storage takes the general kernel, which reads
    at any strides (once refused)."""
    x = torch.randn(1 * 2 * 50 * 64 + 1, device=dev, dtype=torch.bfloat16)
    q = x[1:].view(1, 2, 50, 64)
    sa.reset_counts()
    _assert_close(q, q, q)
    assert sa.LAUNCHES == {"short_attention": 0,
                           "short_attention_general": 1}


# hd 32 float32 (the tiny towers), hd 80 (width 640 / 8 heads), N past the
# mma kernel's 256 (ViT-B/32 at a 512 input: 257; 1025), float16, hd 8 and
# 1, a single token; N on either side of one and two 64-key tiles; hd 15,
# 17 (rows off 16 bytes), 48, 96, 192 and 384 (two 256-dim output blocks)
@pytest.mark.parametrize("b,h,n,hd,dtype", [
    (3, 2, 5, 32, torch.float32), (2, 4, 50, 32, torch.float32),
    (2, 8, 50, 80, torch.bfloat16), (1, 2, 50, 80, torch.float32),
    (2, 12, 257, 64, torch.bfloat16), (1, 12, 1025, 64, torch.bfloat16),
    (1, 2, 257, 64, torch.float32), (2, 12, 50, 64, torch.float16),
    (2, 2, 70, 8, torch.bfloat16), (1, 2, 9, 1, torch.float32),
    (1, 2, 1, 32, torch.float32), (1, 2, 50, 256, torch.bfloat16),
    (1, 2, 63, 80, torch.bfloat16), (1, 2, 64, 32, torch.float32),
    (1, 2, 65, 64, torch.float16), (1, 2, 127, 80, torch.bfloat16),
    (1, 2, 128, 32, torch.float32), (1, 2, 129, 64, torch.float16),
    (2, 2, 50, 15, torch.bfloat16), (2, 2, 50, 17, torch.float16),
    (1, 2, 70, 48, torch.float32), (1, 2, 50, 96, torch.bfloat16),
    (1, 2, 50, 192, torch.float16), (1, 2, 33, 384, torch.bfloat16)],
    ids=str)
def test_general_route_matches_plain(dev, b, h, n, hd, dtype):
    assert sa.short_route(dtype, hd, n) == "general"
    sa.reset_counts()
    _assert_close(*_qkv(b, h, n, hd, b + n + hd, dev, dtype))
    assert sa.LAUNCHES == {"short_attention": 0,
                           "short_attention_general": 1}
    assert sa.REF_CALLS == 0


@pytest.mark.parametrize("n,hd,dtype", [(50, 32, torch.float32),
                                        (257, 64, torch.bfloat16)], ids=str)
def test_general_route_on_strided_views(dev, n, hd, dtype):
    """The ViT's q, k, v at the general route's inputs: slices of one
    [b, n, 3d] product, transposed."""
    b, h = 3, 4
    qkv = torch.randn(b, n, 3 * h * hd, device=dev, dtype=dtype)
    q, k, v = (z.reshape(b, n, h, hd).transpose(1, 2)
               for z in qkv.split(h * hd, dim=-1))
    _assert_close(q, k, v)


@pytest.mark.parametrize("n,hd,dtype", [(50, 32, torch.float32),
                                        (257, 64, torch.bfloat16),
                                        (65, 80, torch.float16),
                                        (50, 15, torch.bfloat16)], ids=str)
def test_general_route_on_rows_off_16_bytes(dev, n, hd, dtype):
    """q, k and v whose rows are off 16 bytes: views one element into
    their storage, and (hd 15) slices of one qkv product whose rows are
    3 x 4 x 15 elements apart.  The general kernel's element loads."""
    b, h = 2, 4
    if hd % 8:
        qkv = torch.randn(b, n, 3 * h * hd, device=dev, dtype=dtype)
        q, k, v = (z.reshape(b, n, h, hd).transpose(1, 2)
                   for z in qkv.split(h * hd, dim=-1))
    else:
        q, k, v = _qkv(b, h, n, hd, n + hd, dev, dtype)
        q, k, v = (torch.empty(z.numel() + 1, device=dev, dtype=dtype)[1:]
                   .view(z.shape).copy_(z) for z in (q, k, v))
    sa.reset_counts()
    _assert_close(q, k, v)
    assert sa.LAUNCHES == {"short_attention": 0,
                           "short_attention_general": 1}


def test_tiny_tower_fused_on_the_card(dev):
    """``ViTConfig.tiny()`` (float32, 2 heads of 32) with
    ``attn_impl='fused'`` on the card: the general kernel, within 1e-5 of
    the einsum tower."""
    import dataclasses

    from vidgraph_tpu_torch.models import vit as tvit

    cfg = tvit.ViTConfig.tiny()
    einsum = tvit.init_vision_tower(cfg, 0, device=dev).eval()
    fused = tvit.init_vision_tower(
        dataclasses.replace(cfg, attn_impl="fused"), 0, device=dev).eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 64, 64, 3)).astype(np.float32)).to(dev)
    sa.reset_counts()
    with torch.no_grad():
        got, want = fused(x), einsum(x)
    torch.cuda.synchronize()
    assert sa.LAUNCHES["short_attention_general"] == cfg.layers
    assert float((got - want).abs().max()) <= 1e-5
