"""The hand-written CUDA FlashAttention forward (``csrc/flash_attention.cu``)
against its plain PyTorch version, on the card.  Marked ``cuda``: they skip
on a host without one.  Run them there with
``python -m pytest tests/test_torch_cuda_flash_attention.py``.

Tolerance: ``|kernel - plain| <= TOL_ABS + TOL_REL * |plain|`` (1e-2 and
2e-2).  Both outputs are bfloat16; the kernel rounds the unnormalised
probabilities to bfloat16 before P.V where the plain version rounds the
normalised ones, and sums in another order, so the two differ by bf16
rounding: about one unit in the last place of the output, for v of unit
scale (the error grows with |v|, not with |output|).
"""
import numpy as np
import pytest
import torch

from vidgraph_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, t, h, seed, dev, qk_scale=1.0, hd=64):
    """q, k, v from a numpy seed; q and k scaled by ``qk_scale``, v of
    unit scale (the tolerance's scale)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(
        (rng.normal(size=(b, t, h, hd)) * s).astype(np.float32)
    ).to(dev, torch.bfloat16) for s in (qk_scale, qk_scale, 1.0)]


def _assert_close(q, k, v, nv):
    got = fa.flash_attention(q, k, v, nv)
    torch.cuda.synchronize()
    ref = fa.attention_ref(q, k, v, nv).to(torch.bfloat16).float()
    got = got.float()
    assert torch.isfinite(got).all()
    excess = (got - ref).abs() - (fa.TOL_ABS + fa.TOL_REL * ref.abs())
    assert float(excess.max()) <= 0, float((got - ref).abs().max())


@pytest.mark.parametrize("b,t,nv", [(1, 2056, 8), (8, 2056, 8),
                                    (2, 1033, 8), (3, 40, 8), (2, 70, 0),
                                    (1, 1, 8), (2, 200, 100), (1, 64, 64)])
def test_flash_matches_plain(dev, b, t, nv):
    _assert_close(*_qkv(b, t, 8, t + nv, dev), nv)


@pytest.mark.parametrize("b,t,nv", [(4, 9, 8), (8, 9, 8), (2, 1033, 8),
                                    (1, 2056, 8), (3, 40, 8), (2, 70, 0)])
def test_flash_head_dim_128_matches_plain(dev, b, t, nv):
    """The heads of ``CaptionerConfig.large()`` (16 x 128); T = 9 is the
    prefill of ``generate`` (nv + BOS)."""
    _assert_close(*_qkv(b, t, 16, t + nv, dev, hd=128), nv)


def test_flash_large_scores(dev):
    """Scores in the hundreds (q and k 4x the unit scale): the running
    max must keep every exponent in range."""
    _assert_close(*_qkv(2, 300, 4, 7, dev, qk_scale=4.0), 8)


def test_prefix_rows_see_the_whole_prefix(dev):
    """Row 0 with nv = 8 averages v over keys 0..7 when all scores tie."""
    q = torch.zeros((1, 16, 1, 64), device=dev, dtype=torch.bfloat16)
    k = torch.zeros_like(q)
    v = torch.arange(16, device=dev, dtype=torch.float32).view(
        1, 16, 1, 1).expand(1, 16, 1, 64).to(torch.bfloat16).contiguous()
    out = fa.flash_attention(q, k, v, nv=8).float()[0, :, 0, 0].cpu()
    want = torch.tensor([3.5] * 8 + [sum(range(r + 1)) / (r + 1)
                                     for r in range(8, 16)])
    torch.testing.assert_close(out, want, atol=2e-2, rtol=0)


def test_launch_counts_and_no_plain_calls(dev):
    q, k, v = _qkv(1, 100, 2, 0, dev)
    fa.reset_counts()
    fa.flash_attention(q, k, v, 8)
    assert fa.LAUNCHES == {"flash_fwd": 1} and fa.REF_CALLS == 0
    fa.flash_attention(q, k, v, 8, flash=False)
    assert fa.LAUNCHES == {"flash_fwd": 1} and fa.REF_CALLS == 1


def test_kernel_rejects_what_it_cannot_take(dev):
    q, k, v = _qkv(1, 100, 2, 0, dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q.float(), k.float(), v.float(), 8)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), 8)
    with pytest.raises(ValueError):
        fa.flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                           v[..., :32].contiguous(), 8)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v[:, :50], 8)
