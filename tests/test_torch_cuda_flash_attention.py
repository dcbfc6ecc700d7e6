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

The general kernels (``csrc/attention_general.cu``: float32, float16 and
every head dim the wgmma kernels do not take) keep those roundings in the
input's type: ``fa.tolerance`` gives float16 the bfloat16 tolerance
scaled by the types' last places (2^-10 / 2^-7), and float32 (no
rounding, another summation order) 1e-5 for the forward and
``BWD_TOL_F32_ABS + BWD_TOL_F32_REL * |plain|`` for the gradients.
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


def _qkv(b, t, h, seed, dev, qk_scale=1.0, hd=64, dtype=torch.bfloat16):
    """q, k, v from a numpy seed; q and k scaled by ``qk_scale``, v of
    unit scale (the tolerance's scale)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(
        (rng.normal(size=(b, t, h, hd)) * s).astype(np.float32)
    ).to(dev, dtype) for s in (qk_scale, qk_scale, 1.0)]


def _assert_close(q, k, v, nv):
    """The kernel against the plain version rounded to the input's type,
    within ``fa.tolerance`` of that type."""
    got = fa.flash_attention(q, k, v, nv)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype
    ref = fa.attention_ref(q, k, v, nv).to(q.dtype).float()
    got = got.float()
    assert torch.isfinite(got).all()
    tol_abs, tol_rel = fa.tolerance(q.dtype)
    excess = (got - ref).abs() - (tol_abs + tol_rel * ref.abs())
    assert float(excess.max()) <= 0, float((got - ref).abs().max())


@pytest.mark.parametrize("b,t,nv", [(1, 2056, 8), (8, 2056, 8),
                                    (2, 1033, 8), (3, 40, 8), (2, 70, 0),
                                    (1, 1, 8), (2, 200, 100), (1, 64, 64)])
def test_flash_matches_plain(dev, b, t, nv):
    _assert_close(*_qkv(b, t, 8, t + nv, dev), nv)


@pytest.mark.parametrize("b,t,nv", [(4, 9, 8), (8, 9, 8), (2, 1033, 8),
                                    (1, 2056, 8), (3, 40, 8), (2, 70, 0),
                                    (8, 2056, 8)])
def test_flash_head_dim_128_matches_plain(dev, b, t, nv):
    """The heads of ``CaptionerConfig.large()`` (16 x 128); T = 9 is the
    prefill of ``generate`` (nv + BOS)."""
    _assert_close(*_qkv(b, t, 16, t + nv, dev, hd=128), nv)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("nv", [0, 8, 64, 150])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 129, 2056, 3080])
def test_forward_edges_and_lse(dev, t, nv, hd):
    """Ragged T around the 64-key stages (the TMA's zero fill) and the
    64-row query tiles, prefixes that span several key tiles: the output
    against ``attention_ref`` and the log-sum-exp against ``lse_ref``, and
    the serving instantiation (no lse) gives the same bits."""
    q, k, v = _qkv(1, t, 2, 7 * t + nv, dev, hd=hd)
    out, lse = fa._cuda_flash(q, k, v, nv, with_lse=True)
    torch.cuda.synchronize()
    ref = fa.attention_ref(q, k, v, nv).to(torch.bfloat16).float()
    excess = (out.float() - ref).abs() - (fa.TOL_ABS + fa.TOL_REL * ref.abs())
    assert torch.isfinite(out.float()).all() and float(excess.max()) <= 0
    torch.testing.assert_close(lse, fa.lse_ref(q, k, nv), atol=2e-3, rtol=0)
    served, none = fa._cuda_flash(q, k, v, nv)
    assert none is None and torch.equal(served, out)


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


GENERAL_NONE = {"flash_fwd_general": 0, "flash_bwd_general_delta": 0,
                "flash_bwd_general": 0, "flash_bwd_general_dq_convert": 0}


def test_launch_counts_and_no_plain_calls(dev):
    q, k, v = _qkv(1, 100, 2, 0, dev)
    fa.reset_counts()
    fa.flash_attention(q, k, v, 8)
    none = {"flash_bwd_delta": 0, "flash_bwd_fused": 0,
            "flash_bwd_dq_convert": 0, **GENERAL_NONE}
    assert fa.LAUNCHES == {"flash_fwd": 1, **none} and fa.REF_CALLS == 0
    fa.flash_attention(q, k, v, 8, flash=False)
    assert fa.LAUNCHES == {"flash_fwd": 1, **none} and fa.REF_CALLS == 1


def test_kernel_rejects_what_it_cannot_take(dev):
    """float32 and a head dim of 32, once refused, now compute on the
    general kernel (what the JAX package computes); a non-contiguous view
    and mismatched shapes are still refused."""
    q, k, v = _qkv(1, 100, 2, 0, dev)
    fa.reset_counts()
    for qq, kk, vv in ((q.float(), k.float(), v.float()),
                       (q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous())):
        got = fa.flash_attention(qq, kk, vv, 8)
        torch.cuda.synchronize()
        assert got.dtype == qq.dtype
        _assert_close(qq, kk, vv, 8)
    assert fa.LAUNCHES["flash_fwd_general"] == 4 and fa.REF_CALLS == 0
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), 8)
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


def _assert_backward_close(b, t, h, hd, nv, dev, qk_scale=1.0,
                           dtype=torch.bfloat16):
    q, k, v = _qkv(b, t, h, 31 * t + nv + hd, dev, qk_scale, hd, dtype)
    do = _qkv(b, t, h, t + 5, dev, hd=hd, dtype=dtype)[2]
    out, grads = _grads(q, k, v, nv, do)
    lse = fa._cuda_flash(q, k, v, nv, with_lse=True)[1]
    torch.cuda.synchronize()
    lse_tol = 2e-3 if dtype != torch.float32 else 1e-5
    torch.testing.assert_close(lse, fa.lse_ref(q, k, nv), atol=lse_tol,
                               rtol=0)
    refs = fa.attention_bwd_ref(q, k, v, out, lse, do, nv)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == dtype, name
        got, ref = got.float(), ref.to(dtype).float()
        assert torch.isfinite(got).all(), name
        err = (got - ref).abs()
        if dtype == torch.float32:
            # float32 products and sums in both, in another order
            excess = err - (fa.BWD_TOL_F32_ABS * max(qk_scale, 1.0)
                            + fa.BWD_TOL_F32_REL * ref.abs())
            assert float(excess.max()) <= 0, (name, float(err.max()))
            continue
        tol_abs, tol_rel = fa.tolerance(dtype)
        # tol_abs is for operands of unit scale: dS is rounded to the input
        # type before it multiplies k (for dq) and q (for dk), so that
        # error grows with their scale, as the forward's grows with |v|
        tol_abs *= 1.0 if name == "dv" else qk_scale
        excess = err - (tol_abs + tol_rel * ref.abs())
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


@pytest.mark.parametrize("t,nv,hd", [(3080, 8, 64), (129, 150, 128),
                                     (2056, 64, 64)])
def test_backward_fed_by_the_forward_lse(dev, t, nv, hd):
    """The backward kernels read the log-sum-exp the wgmma forward writes,
    at the training bucket's length and across prefix tiles."""
    _assert_backward_close(1, t, 2, hd, nv, dev)


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
                           "flash_bwd_fused": 1, "flash_bwd_dq_convert": 1,
                           **GENERAL_NONE}
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
    """float32, once refused, now trains through the general kernels; a
    non-contiguous view, a gradient of another type and a residual of
    another layout are still refused."""
    q, k, v = _qkv(1, 100, 2, 0, dev)
    fa.reset_counts()
    qf = q.float().requires_grad_(True)
    out = fa.flash_attention(qf, k.float(), v.float(), 8)
    out.sum().backward()
    torch.cuda.synchronize()
    assert qf.grad.dtype == torch.float32
    assert fa.LAUNCHES["flash_bwd_general"] == 1 and fa.REF_CALLS == 0
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2).requires_grad_(True),
                           k.transpose(1, 2), v.transpose(1, 2), 8)
    out, lse = fa._cuda_flash(q, k, v, 8, with_lse=True)
    with pytest.raises(ValueError):
        fa._cuda_flash_bwd(q, k, v, out, lse, out.float(), 8)
    with pytest.raises(ValueError):
        fa._cuda_flash_bwd(q, k, v, out, lse.transpose(1, 2), out, 8)


# ------------------------------------------- the general kernels' domain
# head dims the wgmma kernels do not take: below 64 (the tiny and tiny64
# captioners' 16 and 32), between (80: width 640 / 8 heads; 127), above
# (256, 512: multiples of 128 as the TPU kernel takes them) and 1; and the
# edges of the general kernels' instantiations and copies: 8 (one 16-byte
# chunk of a 16-bit row), 15 and 17 (rows off 16 bytes), 48, 96 (the
# three-slot ring's widest), 192 (the 256-dim instantiation, the
# backward's 128-dim output blocks)
GENERAL_HEAD_DIMS = [1, 8, 15, 16, 17, 32, 48, 80, 96, 127, 192, 256, 512]
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("hd", GENERAL_HEAD_DIMS)
@pytest.mark.parametrize("b,t,nv", [(2, 9, 8), (1, 130, 8), (2, 70, 0),
                                    (1, 200, 100)])
def test_general_forward_matches_plain(dev, dtype, hd, b, t, nv):
    """Every float type and head dim the TPU kernel takes, T across tiles,
    prefixes past a tile: the output within ``fa.tolerance`` (float32
    within 1e-5) and the log-sum-exp."""
    q, k, v = _qkv(b, t, 2, hd + t + nv, dev, hd=hd, dtype=dtype)
    assert fa.flash_route(dtype, hd) == "general"
    fa.reset_counts()
    _assert_close(q, k, v, nv)
    out, lse = fa._cuda_flash(q, k, v, nv, with_lse=True)
    torch.cuda.synchronize()
    lse_tol = 2e-3 if dtype != torch.float32 else 1e-5
    torch.testing.assert_close(lse, fa.lse_ref(q, k, nv), atol=lse_tol,
                               rtol=0)
    assert torch.equal(out, fa.flash_attention(q, k, v, nv))
    assert fa.LAUNCHES["flash_fwd_general"] == 3 and fa.LAUNCHES[
        "flash_fwd"] == 0 and fa.REF_CALLS == 0


@pytest.mark.parametrize("dtype", [torch.float16], ids=str)
@pytest.mark.parametrize("hd", [64, 128])
def test_float16_at_the_wgmma_widths(dev, dtype, hd):
    """float16 at hd 64 and 128 takes the general kernels."""
    assert fa.flash_route(dtype, hd) == "general"
    _assert_close(*_qkv(2, 100, 2, hd, dev, hd=hd, dtype=dtype), 8)
    _assert_backward_close(1, 70, 2, hd, 8, dev, dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("hd", [8, 15, 16, 17, 32, 48, 80, 96, 192, 256])
@pytest.mark.parametrize("t,nv", [(1, 8), (9, 8), (65, 0), (130, 70)])
def test_general_backward_matches_plain(dev, dtype, hd, t, nv):
    """The general backward (delta, dk and dv a key tile at a time with dq
    by atomics, dq's conversion) against ``attention_bwd_ref``."""
    fa.reset_counts()
    _assert_backward_close(2, t, 2, hd, nv, dev, dtype=dtype)
    assert fa.LAUNCHES["flash_bwd_general"] == 1
    assert fa.LAUNCHES["flash_bwd_fused"] == 0 and fa.REF_CALLS == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("hd", [32, 80])
@pytest.mark.parametrize("t", [63, 64, 65, 127, 128, 129])
def test_general_kernels_at_the_tile_edges(dev, dtype, hd, t):
    """T on either side of one and two 64-row tiles: the forward, its
    log-sum-exp and the three gradients against the plain versions."""
    fa.reset_counts()
    _assert_close(*_qkv(1, t, 2, 7 * t + hd, dev, hd=hd, dtype=dtype), 8)
    _assert_backward_close(1, t, 2, hd, 8, dev, dtype=dtype)
    assert fa.LAUNCHES["flash_fwd"] == fa.LAUNCHES["flash_bwd_fused"] == 0
    assert fa.LAUNCHES["flash_bwd_general"] == 1 and fa.REF_CALLS == 0


def _off_16_bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x one element into its storage: rows off 16
    bytes."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("hd", [32, 80])
def test_general_kernels_on_rows_off_16_bytes(dev, dtype, hd):
    """q, k and v one element into their storage take the general
    kernels' element loads, forward and backward, with the results of the
    aligned copies' run within the tolerance of the plain versions."""
    q, k, v = (_off_16_bytes(z) for z in _qkv(2, 130, 2, hd, dev, hd=hd,
                                              dtype=dtype))
    assert all(z.data_ptr() % 16 for z in (q, k, v))
    assert not fa.general_plan(hd, q, k, v)[1]
    fa.reset_counts()
    _assert_close(q, k, v, 8)
    do = _qkv(2, 130, 2, 5, dev, hd=hd, dtype=dtype)[2]
    out, grads = _grads(q, k, v, 8, do)
    lse = fa._cuda_flash(q, k, v, 8, with_lse=True)[1]
    refs = fa.attention_bwd_ref(q, k, v, out, lse, do, 8)
    torch.cuda.synchronize()
    g_abs, g_rel = ((fa.BWD_TOL_F32_ABS, fa.BWD_TOL_F32_REL)
                    if dtype == torch.float32 else fa.tolerance(dtype))
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        ref = ref.to(dtype).float()
        excess = (got.float() - ref).abs() - (g_abs + g_rel * ref.abs())
        assert float(excess.max()) <= 0, name
    assert fa.LAUNCHES["flash_bwd_general"] == 1 and fa.REF_CALLS == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_general_backward_at_head_dim_384(dev, dtype):
    """hd 384 (a multiple of 128, as the TPU kernel takes it past 128):
    the backward's three 128-dim output blocks and the forward's two
    256-dim blocks, against the plain gradients."""
    fa.reset_counts()
    _assert_backward_close(1, 130, 2, 384, 8, dev, dtype=dtype)
    assert fa.LAUNCHES["flash_bwd_general"] == 1 and fa.REF_CALLS == 0


@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64),
                                      (torch.bfloat16, 128),
                                      (torch.float32, 32)], ids=str)
def test_batch_times_heads_past_the_grid_limit(dev, dtype, hd):
    """B x h = 65,600 at T = 9 (a grid's y dimension stops at 65,535):
    both routes.  The forward within the tolerance of the plain version;
    the output and the three gradients bit for bit those of the two half
    batches (32,800 heads each, no fold; at T = 9 one key tile adds into
    each dq element once, so dq is deterministic too), and the gradients'
    Frobenius error within ``BWD_REL_FRO`` of the plain norm (float32
    within its element tolerance)."""
    b, h = 8200, 8
    q, k, v = _qkv(b, 9, h, 3, dev, hd=hd, dtype=dtype)
    _assert_close(q, k, v, 8)
    do = _qkv(b, 9, h, 4, dev, hd=hd, dtype=dtype)[2]
    out, grads = _grads(q, k, v, 8, do)
    halves = [_grads(q[s], k[s], v[s], 8, do[s])
              for s in (slice(0, b // 2), slice(b // 2, b))]
    assert torch.equal(out, torch.cat([o for o, _ in halves]))
    for i, got in enumerate(grads):
        assert torch.equal(got, torch.cat([g[i] for _, g in halves])), i
    lse = fa._cuda_flash(q, k, v, 8, with_lse=True)[1]
    refs = fa.attention_bwd_ref(q, k, v, out, lse, do, 8)
    torch.cuda.synchronize()
    for name, got, ref in zip(("dq", "dk", "dv"), grads, refs):
        ref = ref.to(dtype).float()
        err = (got.float() - ref).abs()
        if dtype == torch.float32:
            excess = err - (fa.BWD_TOL_F32_ABS
                            + fa.BWD_TOL_F32_REL * ref.abs())
            assert float(excess.max()) <= 0, name
        assert float(err.norm()) <= BWD_REL_FRO * float(ref.norm()), name


def test_tiny64_captions_on_the_card(dev):
    """The ``tiny64`` preset (float32, 4 heads of 32) captions on the card
    through the general forward, with the tokens of the plain prefill."""
    from vidgraph_tpu_torch.models.captioner import generate
    from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient

    vlm = TPUVLMClient(preset="tiny64", seed=0, max_new=24)
    rng = np.random.default_rng(0)
    chunks = [list(rng.integers(0, 256, (3, 48, 64, 3), dtype=np.uint8))
              for _ in range(4)]
    fa.reset_counts()
    texts = vlm.caption_batch_sync(chunks)
    assert len(texts) == 4 and fa.REF_CALLS == 0
    assert fa.LAUNCHES["flash_fwd_general"] == vlm.cap_cfg.layers
    emb = vlm.embed_frames(vlm.host_frames(chunks))
    vis = vlm.vision_prefixes(chunks, emb)
    flash = generate(vlm._serve_params, vlm.cap_cfg, vis, max_new=24)
    plain = generate(vlm._serve_params, vlm.cap_cfg, vis, max_new=24,
                     flash=False)
    assert torch.equal(flash, plain)


# ------------------------------------------------ the kernels in the model
def _leaf_grads(flash, remat=False):
    from vidgraph_tpu_torch.models import captioner as tcap
    from vidgraph_tpu_torch.models import checkpoint as tck

    cfg = tcap.CaptionerConfig(width=128, layers=2, heads=2, vision_dim=32,
                               num_vision_tokens=4, max_len=128)
    params = tcap.init_params(cfg, 3,
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
