"""Kernels 3, 4 and 5 at every input their TPU kernels take: the port's
plain versions against the JAX package on the CPU, on inputs from a numpy
seed, and the routing functions that send each input to a kernel on the
card.

* The FlashAttention plain version (``attention_ref``, ``lse_ref``,
  ``attention_bwd_ref`` and autograd through ``attention_ref``) against
  the JAX einsum path's masked attention (``models/captioner.py::_block``)
  and ``_attn_flash``'s causal-plus-prefix decomposition, at head dims 16,
  32, 80 and 256 (the widths the wgmma kernels do not take) in float32
  (within 1e-5; gradients within 1e-5 + 1e-5 |ref|) and bfloat16 (within
  the kernels' ``TOL_ABS + TOL_REL |ref|``).
* ``short_attention_ref`` against ``fused_short_attention(interpret=
  True)``: hd 32 float32 at N 5, hd 64 bfloat16 at N 257, hd 80.
* ``q8_matmul``'s plain version against ``q8_matmul(interpret=True)`` at
  M 65 and 200.
* ``flash_route``, ``short_route`` and ``slabs``: no input that the JAX
  package computes is refused, and the shapes the fast kernels took keep
  their route.

The kernels themselves are held to these plain versions on the card
(``tests/test_torch_cuda_{flash_attention,short_attention,q8_matmul}.py``,
``chip_smoke.py`` phase 26).
"""
import os

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.ops import short_attention as jsa  # noqa: E402
from vidgraph_tpu.ops.q8_matmul import q8_matmul as jax_q8  # noqa: E402
from vidgraph_tpu_torch.ops import flash_attention as fa  # noqa: E402
from vidgraph_tpu_torch.ops import q8_matmul as q8  # noqa: E402
from vidgraph_tpu_torch.ops import short_attention as sa  # noqa: E402

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16),
       "f16": (jnp.float16, torch.float16)}
HEAD_DIMS = [16, 32, 80, 256]
# bytes of the tiny64 captions compared with the JAX package's
TINY64_NEW = 32


def _arrays(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _mask(t, nv):
    idx = jnp.arange(t)
    mask = jnp.where(idx[None, :] <= idx[:, None], 0.0, -1e30)
    return mask.at[:, :nv].set(0.0)


def _jax_einsum(q, k, v, nv):
    """The JAX ``_block``'s einsum attention under ``forward``'s mask,
    float32 out (before ``_block``'s cast)."""
    hd = q.shape[-1]
    att = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                     preferred_element_type=jnp.float32) / jnp.sqrt(hd)
    att = jax.nn.softmax(att + _mask(q.shape[1], nv)[None, None], axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", att.astype(v.dtype), v,
                      preferred_element_type=jnp.float32)


def _jax_decomposition(q, k, v, nv):
    """``_attn_flash``: causal softmax over the whole sequence (scale
    ``1/sqrt(hd)``), the nv x nv prefix corner recomputed densely."""
    t, hd = q.shape[1], q.shape[-1]
    idx = jnp.arange(t)
    causal = jnp.where(idx[None, :] <= idx[:, None], 0.0, -1e30)
    att = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                     preferred_element_type=jnp.float32) * (1.0 / hd ** 0.5)
    att = jax.nn.softmax(att + causal[None, None], axis=-1)
    o = jnp.einsum("bhqk,bkhd->bqhd", att.astype(v.dtype), v,
                   preferred_element_type=jnp.float32)
    if nv:
        op = _jax_einsum(q[:, :nv], k[:, :nv], v[:, :nv], nv)
        o = jnp.concatenate([op, o[:, nv:]], axis=1)
    return o


def _close(got, ref, dt, atol_f32=1e-5):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    if dt == "f32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol_f32)
    else:
        tol_abs, tol_rel = fa.tolerance(_DT[dt][1])
        excess = np.abs(got - ref) - (tol_abs + tol_rel * np.abs(ref))
        assert excess.max() <= 0, float(np.abs(got - ref).max())


@pytest.mark.parametrize("hd,dt,t,nv", [
    *((hd, dt, t, nv) for dt in ("f32", "bf16") for hd in HEAD_DIMS
      for t, nv in ((9, 8), (70, 4))),
    (32, "f16", 70, 4)])
def test_flash_plain_forward_matches_jax(hd, dt, t, nv):
    """``attention_ref`` and ``flash_attention`` on a CPU tensor against
    the einsum path and the flash decomposition (which JAX computes in
    float16 too, so the port takes it); ``lse_ref`` against JAX's
    log-sum-exp."""
    jdt, tdt = _DT[dt]
    arrays = _arrays((2, t, 2, hd), hd + t)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)
    fa.reset_counts()
    got = fa.flash_attention(tq, tk, tv, nv)
    assert fa.REF_CALLS == 1 and sum(fa.LAUNCHES.values()) == 0
    _close(got, _jax_einsum(jq, jk, jv, nv), dt)
    _close(got, _jax_decomposition(jq, jk, jv, nv), dt)
    att = jnp.einsum("bqhd,bkhd->bhqk", jq, jk,
                     preferred_element_type=jnp.float32) / jnp.sqrt(hd)
    want = jax.nn.logsumexp(att + _mask(t, nv)[None, None], axis=-1)
    np.testing.assert_allclose(fa.lse_ref(tq, tk, nv).numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_flash_plain_gradients_match_jax(hd, dt):
    """Autograd through ``attention_ref`` against ``jax.grad`` of the
    einsum path, and ``attention_bwd_ref`` (the plain version of the
    backward kernels) against that autograd, at T 40 with nv 8."""
    jdt, tdt = _DT[dt]
    t, nv = 40, 8
    arrays = _arrays((2, t, 2, hd), 3 * hd, n=4)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays[:3])
    do = arrays[3]
    want = jax.grad(lambda *a: jnp.sum(_jax_einsum(*a, nv) * do),
                    argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True)
                  for a in arrays[:3])
    out = fa.attention_ref(tq, tk, tv, nv)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        _close(g.float(), w, dt)
    tq, tk, tv = (z.detach() for z in (tq, tk, tv))
    plain = fa.attention_bwd_ref(tq, tk, tv, out.detach(),
                                 fa.lse_ref(tq, tk, nv),
                                 torch.from_numpy(do).to(tdt), nv)
    for name, g, w in zip("qkv", plain, got):
        assert g.dtype == torch.float32, name
        if dt == "f32":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"d{name}")
        else:
            _close(g, w.float(), dt)


@pytest.mark.parametrize("b,h,n,hd,dt", [(3, 2, 5, 32, "f32"),
                                         (1, 2, 257, 64, "bf16"),
                                         (2, 4, 50, 80, "bf16"),
                                         (1, 2, 50, 80, "f32")])
def test_short_attention_plain_matches_the_pallas_kernel(b, h, n, hd, dt):
    jdt, tdt = _DT[dt]
    arrays = _arrays((b, h, n, hd), n + hd)
    ref = jsa.fused_short_attention(*(jnp.asarray(a, jdt) for a in arrays),
                                    interpret=True)
    sa.reset_counts()
    got = sa.fused_short_attention(*(torch.from_numpy(a).to(tdt)
                                     for a in arrays))
    assert got.dtype == tdt and got.shape == (b, h, n, hd)
    assert sa.REF_CALLS == 1 and sum(sa.LAUNCHES.values()) == 0
    if dt == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=sa.TOL_F32)
    else:
        got, ref = got.float().numpy(), np.asarray(ref, np.float32)
        excess = np.abs(got - ref) - (sa.TOL_ABS + sa.TOL_REL * np.abs(ref))
        assert excess.max() <= 0, float(np.abs(got - ref).max())


@pytest.mark.parametrize("m", [65, 200])
def test_q8_plain_matches_the_pallas_kernel_past_64_rows(m):
    k, n = 256, 384
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.02).astype(np.float32)
    s = (np.abs(w).max(0) / 127.0).astype(np.float32)
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    ref = np.asarray(jax_q8(jnp.asarray(x), jnp.asarray(q), jnp.asarray(s),
                            interpret=True))
    q8.reset_counts()
    got = q8.q8_matmul(*map(torch.from_numpy, (x, q, s)))
    assert got.shape == (m, n) and q8.REF_CALLS == 1
    assert np.abs(got.numpy() - ref).max() <= q8.TOL_REL * np.abs(ref).max()


def test_flash_route_takes_every_float_type_and_head_dim():
    """Every hd the TPU kernel takes (1-127, multiples of 128 up to 1024)
    in float32, bfloat16 and float16 has a route; bfloat16 at 64 and 128
    keeps the wgmma kernels, everything else takes the general ones."""
    dims = [*range(1, 128), *range(128, 1025, 128)]
    for dtype in fa.FLOAT_TYPES:
        for hd in dims:
            want = ("wgmma" if dtype == torch.bfloat16 and hd in (64, 128)
                    else "general")
            assert fa.flash_route(dtype, hd) == want, (dtype, hd)
    for bad in (torch.int8, torch.int32):
        with pytest.raises(ValueError):
            fa.flash_route(bad, 64)
    assert fa.tolerance(torch.float32) == (fa.TOL_F32, 0.0)


def test_short_route_takes_every_input_of_the_pallas_kernel():
    """hd a multiple of 8 up to 256 (and others), any N from 1 to 2048, in
    float32, bfloat16 and float16: the mma kernel keeps bfloat16 at hd 64,
    N <= 256 with aligned rows, the general kernel takes the rest."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for hd in (*range(8, 257, 8), 1, 3, 33):
            for n in (1, 5, 49, 50, 64, 197, 256, 257, 1025, 2048):
                fast = dtype == torch.bfloat16 and hd == 64 and n <= 256
                assert sa.short_route(dtype, hd, n) == (
                    "mma" if fast else "general"), (dtype, hd, n)
                assert sa.short_route(dtype, hd, n, aligned=False) \
                    == "general"
    with pytest.raises(ValueError):
        sa.short_route(torch.int32, 64, 50)


def test_rows_aligned_reads_the_views():
    """The ViT's slices of one qkv product are aligned at hd 64; a view
    one element into its storage, or q, k, v at other strides, are not."""
    qkv = torch.zeros(2, 50, 3 * 768, dtype=torch.bfloat16)
    q, k, v = (z.reshape(2, 50, 12, 64).transpose(1, 2)
               for z in qkv.split(768, dim=-1))
    assert sa._rows_aligned(q, k, v)
    x = torch.zeros(2 * 50 * 64 + 1, dtype=torch.bfloat16)
    off = x[1:].view(1, 2, 50, 64)
    assert not sa._rows_aligned(off, off, off)
    assert not sa._rows_aligned(q, k, v.contiguous())


def _view(kind, hd, dtype):
    """[B, h, T, hd] views of the general kernels' layouts: the flash
    route's contiguous [B, T, h, hd] (transposed), the ViT's slices of one
    qkv product, and a contiguous view one element into its storage."""
    b, t, h = 2, 9, 4
    if kind == "contiguous":
        return torch.zeros(b, t, h, hd, dtype=dtype).transpose(1, 2)
    if kind == "qkv_slice":
        qkv = torch.zeros(b, t, 3 * h * hd, dtype=dtype)
        return qkv[..., h * hd:2 * h * hd].reshape(b, t, h, hd).transpose(1, 2)
    x = torch.zeros(b * h * t * hd + 1, dtype=dtype)
    return x[1:].view(b, h, t, hd)


# (head dim, float type, layout) -> the forward's and the backward's
# head-dim maxima and whether every row lies on 16 bytes
@pytest.mark.parametrize("hd,dt,kind,fwd_max,bwd_max,aligned", [
    (32, "f32", "contiguous", 64, 64, True),
    (32, "bf16", "qkv_slice", 64, 64, True),
    (8, "f16", "contiguous", 64, 64, True),
    (15, "bf16", "contiguous", 64, 64, False),
    (17, "f32", "contiguous", 64, 64, False),
    (64, "bf16", "offset", 64, 64, False),
    (80, "bf16", "contiguous", 128, 128, True),
    (96, "f16", "qkv_slice", 128, 128, True),
    (128, "f32", "offset", 128, 128, False),
    (192, "bf16", "contiguous", 256, 128, True),
    (256, "f32", "contiguous", 256, 128, True),
    (384, "bf16", "contiguous", 256, 128, True),
    (512, "f16", "qkv_slice", 256, 128, True)])
def test_general_plan_picks_the_instantiation(hd, dt, kind, fwd_max,
                                              bwd_max, aligned):
    """``general_plan``: the smallest head-dim maximum that holds hd (the
    largest past it, whose output blocks split hd), and 16-byte rows only
    where every pointer, stride and hd allow 16-byte copies."""
    x = _view(kind, hd, _DT[dt][1])
    assert fa.general_plan(hd, x, x, x) == (fwd_max, aligned)
    assert fa.general_plan(hd, x, x, x, backward=True) == (bwd_max, aligned)


@pytest.mark.parametrize("m", [1, 8, 63, 64, 65, 128, 129, 200, 1000])
def test_slabs_cover_every_row_once(m):
    """``slabs`` cuts M into 64-row slabs that cover every row once; M <=
    64 stays one launch; each slab has a plan."""
    parts = q8.slabs(m)
    rows = [r for r0, n in parts for r in range(r0, r0 + n)]
    assert rows == list(range(m))
    assert all(1 <= n <= q8.MAX_M for _, n in parts)
    assert len(parts) == -(-m // q8.MAX_M)
    if m <= q8.MAX_M:
        assert parts == ((0, m),)
    for _, n in parts:
        assert q8.plan(n, 2048, 8192).rows >= n
    with pytest.raises(ValueError):
        q8.slabs(0)


def test_tiny64_caption_on_the_cpu_equals_jax():
    """``TPUVLMClient(preset="tiny64", seed=0)`` of both packages, the JAX
    client served single-device, on the frames that ``chip_smoke.py``
    phase 26 captions on the card (4 chunks of 3 frames of 64 x 64 from
    numpy seed 26): equal captions of ``TINY64_NEW`` bytes (a greedy
    decode's first bytes do not depend on its budget).  On the card the
    port's caption is held to the port's CPU caption, and so, over these
    bytes, to the JAX package's."""
    from vidgraph_tpu.parallel import serving as jserving
    from vidgraph_tpu.services.vlm_client import TPUVLMClient as JaxVLM
    from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient

    chunks = [list(c) for c in np.random.default_rng(26).integers(
        0, 256, (4, 3, 64, 64, 3), dtype=np.uint8)]
    jserving.configure(enabled=False)
    try:
        want = JaxVLM(preset="tiny64", seed=0,
                      max_new=TINY64_NEW).caption_batch_sync(chunks)
    finally:
        jserving.configure(enabled="auto")
    got = TPUVLMClient(preset="tiny64", seed=0,
                       max_new=TINY64_NEW).caption_batch_sync(chunks)
    assert len(got) == 4 and got == want
