"""The hand-written CUDA FlashAttention forward (``csrc/flash_attention.cu``)
and backward (``csrc/flash_attention_bwd.cu``) against their plain PyTorch
versions, on the card.  Marked ``cuda``: they skip
on a host without one.  Run them there with
``python -m pytest tests/test_torch_cuda_flash_attention.py``.

Tolerance: ``|kernel - plain| <= TOL_ABS + TOL_REL * |plain|`` (1e-2 and
2e-2).  Both outputs are bfloat16; the kernel rounds the unnormalised
probabilities to bfloat16 before P.V where the plain version rounds the
normalised ones, and sums in another order, so the two differ by bf16
rounding: about one unit in the last place of the output, for v of unit
scale (the error grows with |v|, not with |output|).  The backward
kernels round P and dS to bfloat16 as tensor-core operands and dq, dk, dv
once on the way out, where ``attention_bwd_ref`` is float32 throughout:
the same tolerance against the plain gradients rounded to bfloat16, and,
since the gradients of late rows are far below ``TOL_ABS``, also a
Frobenius error of at most ``BWD_REL_FRO`` of the gradient's norm.
"""
import math

import numpy as np
import pytest
import torch

from vidgraph_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

BWD_REL_FRO = 2e-2     # ||kernel - plain||_F / ||plain||_F, per gradient


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
    none = {"flash_bwd_delta": 0, "flash_bwd_fused": 0,
            "flash_bwd_dq_convert": 0}
    assert fa.LAUNCHES == {"flash_fwd": 1, **none} and fa.REF_CALLS == 0
    fa.flash_attention(q, k, v, 8, flash=False)
    assert fa.LAUNCHES == {"flash_fwd": 1, **none} and fa.REF_CALLS == 1


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


# ------------------------------------------------------------- the backward
def _grads(q, k, v, nv, do):
    """(out, lse, (dq, dk, dv)) through ``FlashAttentionFn``."""
    q, k, v = (z.detach().requires_grad_(True) for z in (q, k, v))
    out = fa.flash_attention(q, k, v, nv)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    return out.detach(), grads


def _assert_backward_close(b, t, h, hd, nv, dev, qk_scale=1.0):
    q, k, v = _qkv(b, t, h, 31 * t + nv + hd, dev, qk_scale, hd)
    do = _qkv(b, t, h, t + 5, dev, hd=hd)[2]
    out, grads = _grads(q, k, v, nv, do)
    lse = fa._cuda_flash(q, k, v, nv, with_lse=True)[1]
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, fa.lse_ref(q, k, nv), atol=2e-3, rtol=0)
    refs = fa.attention_bwd_ref(q, k, v, out, lse, do, nv)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        got, ref = got.float(), ref.to(torch.bfloat16).float()
        assert torch.isfinite(got).all(), name
        err = (got - ref).abs()
        # TOL_ABS is for operands of unit scale: dS is rounded to bfloat16
        # before it multiplies k (for dq) and q (for dk), so that error
        # grows with their scale, as the forward's grows with |v|
        tol_abs = fa.TOL_ABS * (1.0 if name == "dv" else qk_scale)
        excess = err - (tol_abs + fa.TOL_REL * ref.abs())
        assert float(excess.max()) <= 0, (name, float(err.max()))
        # rms error against rms gradient; the floor is for a gradient that
        # is zero but for rounding (dq and dk at T = 1, where P = 1)
        slack = BWD_REL_FRO * float(ref.norm()) + 1e-3 * ref.numel() ** 0.5
        assert float(err.norm()) <= slack, (name, float(err.norm()), slack)


@pytest.mark.parametrize("nv", [0, 8])
@pytest.mark.parametrize("t", [1, 9, 40, 65, 1033])
@pytest.mark.parametrize("h,hd", [(8, 64), (4, 128)])
def test_backward_matches_plain(dev, h, hd, t, nv):
    _assert_backward_close(2, t, h, hd, nv, dev)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("b,t,h,nv", [(1, 200, 2, 100), (1, 64, 2, 64),
                                      (1, 130, 2, 70), (2, 300, 2, 150)])
def test_backward_with_a_long_prefix(dev, b, t, h, nv, hd):
    """A prefix longer than a tile: key tiles above the diagonal are still
    visible to the rows below nv, and the masked-chunk skips must not hide
    them."""
    _assert_backward_close(b, t, h, hd, nv, dev)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("t", [2, 17, 63, 64, 127, 129, 200])
def test_backward_ragged_lengths(dev, t, hd):
    """T off a multiple of the 64-row tiles (and of the 32-query chunks and
    16-key steps): the ragged tiles are zero-filled and masked."""
    _assert_backward_close(2, t, 2, hd, 8, dev)


def test_backward_large_scores(dev):
    """Scores in the hundreds: the probabilities are recomputed against
    the saved log-sum-exp without overflow."""
    _assert_backward_close(2, 300, 4, 64, 8, dev, qk_scale=4.0)


@pytest.mark.parametrize("hd", [64, 128])
def test_backward_two_runs_give_the_same_bits(dev, hd):
    """dk and dv are written by the block that owns their keys, so two runs
    give the same bits.  dq is summed across key tiles by float32 atomics
    in an order that changes from run to run: two runs' float32
    accumulators stay within 1e-6 of its Frobenius norm, and the bf16 dq
    rounded from them within one bf16 step (2^-7 of the larger)."""
    q, k, v = _qkv(2, 1033, 4, 3, dev, hd=hd)
    do = _qkv(2, 1033, 4, 4, dev, hd=hd)[2]
    first = _grads(q, k, v, 8, do)[1]
    second = _grads(q, k, v, 8, do)[1]
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[2], second[2])
    dq1, dq2 = first[0].float(), second[0].float()
    assert bool(((dq1 - dq2).abs()
                 <= 2.0 ** -7 * torch.maximum(dq1.abs(), dq2.abs())).all())
    out, lse = fa._cuda_flash(q, k, v, 8, with_lse=True)
    accs = []
    for _ in range(2):
        delta, acc = fa._cuda_delta(out, do)
        fa._cuda_bwd_fused(q, k, v, do, lse, delta, acc, 8)
        accs.append(acc)
    torch.cuda.synchronize()
    assert float((accs[0] - accs[1]).norm()) <= 1e-6 * float(accs[0].norm())
    scale = 1.0 / math.sqrt(hd)
    assert torch.equal(fa._cuda_dq_convert(accs[0]),
                       (accs[0] * scale).to(torch.bfloat16))


def test_backward_launch_counts(dev):
    q, k, v = _qkv(1, 100, 2, 0, dev)
    fa.reset_counts()
    _grads(q, k, v, 8, torch.ones_like(q))
    assert fa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_delta": 1,
                           "flash_bwd_fused": 1, "flash_bwd_dq_convert": 1}
    assert fa.REF_CALLS == 0
    fa.reset_counts()
    with torch.no_grad():
        out = fa.flash_attention(q.requires_grad_(True), k, v, 8)
    assert out.grad_fn is None and fa.LAUNCHES["flash_fwd"] == 1


def test_backward_without_delta_is_caught(dev):
    """The planted fault of the smoke run: the plain backward without
    ``delta`` lies outside the tolerance that the kernels meet."""
    q, k, v = _qkv(2, 200, 4, 11, dev)
    do = _qkv(2, 200, 4, 12, dev)[2]
    out, grads = _grads(q, k, v, 8, do)
    lse = fa._cuda_flash(q, k, v, 8, with_lse=True)[1]
    bad = fa.attention_bwd_ref(q, k, v, out, lse, do, 8, use_delta=False)
    err = (grads[0].float() - bad[0]).abs()
    assert float((err - fa.TOL_ABS - fa.TOL_REL * bad[0].abs()).max()) > 0


def test_backward_rejects_what_it_cannot_take(dev):
    q, k, v = _qkv(1, 100, 2, 0, dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q.float().requires_grad_(True), k.float(),
                           v.float(), 8)
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2).requires_grad_(True),
                           k.transpose(1, 2), v.transpose(1, 2), 8)
    out, lse = fa._cuda_flash(q, k, v, 8, with_lse=True)
    with pytest.raises(ValueError):
        fa._cuda_flash_bwd(q, k, v, out, lse, out.float(), 8)
    with pytest.raises(ValueError):
        fa._cuda_flash_bwd(q, k, v, out, lse.transpose(1, 2), out, 8)


# ------------------------------------------------ the kernels in the model
def _leaf_grads(flash, remat=False):
    from vidgraph_tpu_torch.models import captioner as tcap
    from vidgraph_tpu_torch.models import checkpoint as tck

    cfg = tcap.CaptionerConfig(width=128, layers=2, heads=2, vision_dim=32,
                               num_vision_tokens=4, max_len=128)
    params = tcap.init_params(cfg, torch.Generator().manual_seed(3),
                              device=torch.device("cuda"),
                              requires_grad=True)
    rng = np.random.default_rng(0)
    vis = torch.from_numpy(rng.normal(size=(2, 4, 32)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, 256, (2, 90)))
    logits = tcap.forward(params, cfg, vis.cuda(), toks.cuda(), remat=remat,
                          flash=flash)
    logits.square().mean().backward()
    torch.cuda.synchronize()
    return {k: p.grad for k, p in tck.tree_leaves(params)}


@pytest.mark.parametrize("remat", [False, True])
def test_flash_forward_does_not_cut_the_gradient_on_the_card(dev, remat):
    """``forward(..., flash=True)`` under autograd on the card: every leaf
    below the attention gets the gradient the plain version gives it,
    within 5% of the leaf's largest (bfloat16 compute)."""
    fa.reset_counts()
    flash = _leaf_grads(True, remat)
    layers = 2
    assert fa.LAUNCHES["flash_bwd_fused"] == \
        fa.LAUNCHES["flash_bwd_dq_convert"] == layers and fa.REF_CALLS == 0
    assert fa.LAUNCHES["flash_fwd"] == layers * (2 if remat else 1)
    plain = _leaf_grads(False)
    for key, ref in plain.items():
        assert flash[key] is not None, key
        rel = float((flash[key] - ref).abs().max()) / max(
            float(ref.abs().max()), 1e-30)
        assert rel < 0.05, (key, rel)
    assert float(flash["blocks/0/qkv_w"].abs().max()) > 0


def test_fused_vit_attention_raises_under_autograd(dev):
    """The short-attention kernel has no backward: training the tower with
    ``attn_impl='fused'`` on the card raises, and ``einsum`` trains."""
    from vidgraph_tpu_torch.models import vit as tvit

    cfg = tvit.ViTConfig(image_size=64, patch_size=32, width=128, layers=1,
                         heads=2, embed_dim=32, attn_impl="fused")
    tower = tvit.init_vision_tower(cfg, device=dev)
    x = torch.randn(2, 64, 64, 3, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        tower(x)
    with torch.no_grad():
        assert tower(x).shape == (2, 32)
