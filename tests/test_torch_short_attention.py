"""The port's short-sequence ViT attention (``ops/short_attention.py``,
plain versions) against the JAX package's ``fused_short_attention`` (the
Pallas kernel in interpret mode, as ``tests/test_short_attention.py`` runs
it) and ``packed_attention``, on inputs from a numpy seed.

Tolerances: float32 within 1e-5 (the same arithmetic in another summation
order); bfloat16 within ``0.01 + 0.02 |ref|``: both round the
probabilities and the output to bfloat16, at places a few ulps apart.
"""
import os

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.ops import short_attention as jsa  # noqa: E402
from vidgraph_tpu_torch.ops import short_attention as tsa  # noqa: E402

_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(b, h, n, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, n, hd)).astype(np.float32)
            for _ in range(3)]


def _both(arrays, dt):
    jdt, tdt = _DT[dt]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, ref, dt):
    got = got.float().numpy()
    ref = np.asarray(ref).astype(np.float32)
    if dt == "f32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=tsa.TOL_F32)
    else:
        assert (np.abs(got - ref) <= 0.01 + 0.02 * np.abs(ref)).all(), \
            float(np.abs(got - ref).max())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 5])
def test_fused_matches_the_pallas_kernel(b, dt):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, 12, 50, 64, b), dt)
    ref = jsa.fused_short_attention(jq, jk, jv, interpret=True)
    got = tsa.fused_short_attention(tq, tk, tv)
    assert got.dtype == tv.dtype and got.shape == (b, 12, 50, 64)
    _close(got, ref, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 5])
def test_packed_matches_the_jax_packing(b, dt):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, 12, 50, 64, 10 + b), dt)
    _close(tsa.packed_attention(tq, tk, tv),
           jsa.packed_attention(jq, jk, jv), dt)


def test_plain_versions_agree_with_each_other():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 4, 7, 32, 3))
    torch.testing.assert_close(tsa.short_attention_ref(q, k, v),
                               tsa.packed_attention(q, k, v),
                               rtol=0, atol=1e-6)


def test_strided_views_of_one_product():
    """The ViT hands the kernel slices of one qkv product, transposed;
    the plain version takes them as they are."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.normal(size=(2, 50, 3 * 128)).astype(
        np.float32))
    q, k, v = (z.reshape(2, 50, 2, 64).transpose(1, 2)
               for z in qkv.split(128, dim=-1))
    got = tsa.fused_short_attention(q, k, v)
    ref = jsa.fused_short_attention(*(jnp.asarray(z.contiguous().numpy())
                                      for z in (q, k, v)), interpret=True)
    _close(got, ref, "f32")


def test_odd_head_count_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 3, 50, 64, 0))
    with pytest.raises(ValueError, match="even head count"):
        tsa.fused_short_attention(q, k, v)
    with pytest.raises(ValueError):
        jsa.fused_short_attention(*(jnp.asarray(a) for a in
                                    _qkv(1, 3, 50, 64, 0)), interpret=True)


def test_counts():
    """A CPU tensor takes the plain version: counted there, no launch."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 5, 32, 0))
    tsa.reset_counts()
    tsa.fused_short_attention(q, k, v)
    tsa.fused_short_attention(q, k, v)
    assert tsa.REF_CALLS == 2 and tsa.LAUNCHES == {
        "short_attention": 0, "short_attention_general": 0}
