"""Gradients of the port's attention on the CPU, against the JAX package.

* Autograd through the plain version ``attention_ref`` against ``jax.grad``
  of the JAX einsum path's masked attention (``models/captioner.py::_block``
  with the mask of ``forward``), float32, within 1e-5 (the same arithmetic
  in another summation order).
* ``attention_bwd_ref``, the plain version of the CUDA backward kernels
  (the formulas over the saved log-sum-exp), against that autograd: 1e-5 in
  float32; for bfloat16 inputs within ``TOL_ABS + TOL_REL * |ref|``, since
  ``attention_ref`` rounds the probabilities to bfloat16 and the plain
  backward does not.
* The regression for a gradient cut at the attention: ``forward(...,
  flash=True)`` must give ``blocks/0/qkv_w`` the gradient ``flash=False``
  gives it (on the CPU both take the plain version; the card's counterpart
  is in ``tests/test_torch_cuda_flash_attention.py``).
"""
import os

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu_torch.models import captioner as tcap  # noqa: E402
from vidgraph_tpu_torch.models import checkpoint as tck  # noqa: E402
from vidgraph_tpu_torch.ops import flash_attention as fa  # noqa: E402

B, H, HD = 2, 3, 16


def _inputs(t, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, t, H, HD)).astype(dtype) for _ in range(4)]


def _jax_attention(q, k, v, nv):
    """The einsum path of the JAX ``_block`` under ``forward``'s mask."""
    t, hd = q.shape[1], q.shape[-1]
    idx = jnp.arange(t)
    mask = jnp.where(idx[None, :] <= idx[:, None], 0.0, -1e30)
    mask = mask.at[:, :nv].set(0.0)
    att = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                     preferred_element_type=jnp.float32) / jnp.sqrt(hd)
    att = jax.nn.softmax(att + mask[None, None], axis=-1)
    return jnp.einsum("bhqk,bkhd->bqhd", att, v,
                      preferred_element_type=jnp.float32)


def _autograd(q, k, v, do, nv):
    q, k, v = (torch.from_numpy(z).requires_grad_(True) for z in (q, k, v))
    out = fa.attention_ref(q, k, v, nv)
    return out.detach(), torch.autograd.grad(out, (q, k, v),
                                             torch.from_numpy(do))


@pytest.mark.parametrize("nv", [0, 2, 8])
@pytest.mark.parametrize("t", [1, 17, 70])
def test_autograd_through_attention_ref_matches_jax_grad(nv, t):
    q, k, v, do = _inputs(t, 100 * nv + t)
    want = jax.grad(lambda *a: jnp.sum(_jax_attention(*a, nv) * do),
                    argnums=(0, 1, 2))(q, k, v)
    _, got = _autograd(q, k, v, do, nv)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("nv", [0, 2, 8])
@pytest.mark.parametrize("t", [1, 17, 70])
def test_attention_bwd_ref_matches_autograd(nv, t):
    q, k, v, do = _inputs(t, 7 + 100 * nv + t)
    out, want = _autograd(q, k, v, do, nv)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    got = fa.attention_bwd_ref(tq, tk, tv, out, fa.lse_ref(tq, tk, nv), tdo,
                               nv)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("nv,t", [(0, 17), (8, 70), (2, 33)])
def test_attention_bwd_ref_bf16_within_the_kernel_tolerance(nv, t):
    q, k, v, do = (torch.from_numpy(z).to(torch.bfloat16)
                   for z in _inputs(t, 3 + nv + t))
    qr, kr, vr = (z.clone().requires_grad_(True) for z in (q, k, v))
    out = fa.attention_ref(qr, kr, vr, nv)
    want = torch.autograd.grad(out, (qr, kr, vr), do.float())
    got = fa.attention_bwd_ref(q, k, v, out.detach(), fa.lse_ref(q, k, nv),
                               do, nv)
    for name, g, w in zip("qkv", got, want):
        w = w.float()
        excess = (g - w).abs() - (fa.TOL_ABS + fa.TOL_REL * w.abs())
        assert float(excess.max()) <= 0, f"d{name}"


@pytest.mark.parametrize("nv", [0, 8])
def test_lse_ref_matches_jax_logsumexp(nv):
    q, k, _, _ = _inputs(40, nv)
    idx = jnp.arange(40)
    mask = jnp.where(idx[None, :] <= idx[:, None], 0.0, -1e30)
    mask = mask.at[:, :nv].set(0.0)
    att = jnp.einsum("bqhd,bkhd->bhqk", q, k) / jnp.sqrt(HD)
    want = jax.nn.logsumexp(att + mask[None, None], axis=-1)
    got = fa.lse_ref(torch.from_numpy(q), torch.from_numpy(k), nv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_bwd_ref_without_delta_differs():
    """``use_delta=False`` is the planted fault of the card's checks: it
    must move dq and dk (dv does not depend on delta)."""
    q, k, v, do = map(torch.from_numpy, _inputs(17, 5))
    out = fa.attention_ref(q, k, v, 2)
    lse = fa.lse_ref(q, k, 2)
    good = fa.attention_bwd_ref(q, k, v, out, lse, do, 2)
    bad = fa.attention_bwd_ref(q, k, v, out, lse, do, 2, use_delta=False)
    assert float((good[0] - bad[0]).abs().max()) > 1e-2
    assert float((good[1] - bad[1]).abs().max()) > 1e-2
    assert torch.equal(good[2], bad[2])


def _qkv_grad(flash: bool, remat: bool = False):
    cfg = tcap.CaptionerConfig.tiny()
    params = tcap.init_params(cfg, 3,
                              requires_grad=True)
    rng = np.random.default_rng(0)
    vis = torch.from_numpy(rng.normal(size=(2, 2, 32)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, 256, (2, 12)))
    logits = tcap.forward(params, cfg, vis, toks, remat=remat, flash=flash)
    logits.square().mean().backward()
    return {k: p.grad for k, p in tck.tree_leaves(params)}


def test_flash_forward_does_not_cut_the_gradient():
    """The gradient reaches what lies below the attention (``qkv_w``, the
    first layer norm, the embeddings) with ``flash=True`` as with
    ``flash=False``."""
    flash, plain = _qkv_grad(True), _qkv_grad(False)
    for key in ("blocks/0/qkv_w", "blocks/0/ln1_scale", "tok_emb",
                "pos_emb", "vis_proj_w"):
        assert flash[key] is not None, key
        assert float(flash[key].abs().max()) > 0, key
        torch.testing.assert_close(flash[key], plain[key], atol=1e-6,
                                   rtol=0)


def test_flash_engaged_is_false_on_the_cpu():
    with pytest.warns(RuntimeWarning, match="flash attention requested"):
        assert tcap.flash_engaged(True, torch.device("cpu")) is False
    assert tcap.flash_engaged(False, torch.device("cpu")) is False
    assert tcap.flash_engaged(True, "cuda") is True


def test_a_quantised_tree_is_not_trainable():
    from vidgraph_tpu_torch.models.quant8 import quantize_captioner_params

    cfg = tcap.CaptionerConfig.tiny()
    q8 = quantize_captioner_params(tcap.init_params(cfg))
    with pytest.raises(ValueError, match="Q8"):
        tcap.trainable(q8)
