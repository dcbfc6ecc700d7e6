"""The port's vision tower (``models/vit.py``) against the JAX package's
Flax tower, on the CPU, with the Flax weights carried across by
``convert.vit_params_from_jax`` or a JAX-written npz, and images from a
numpy seed.

Tolerances:
* ``ViTConfig.tiny()`` (float32): embeddings within 1e-5 under every
  ``attn_impl`` (the same float32 arithmetic in another summation order;
  the JAX ``fused`` path runs the Pallas kernel in interpret mode);
* a bf16 config at ViT-B/32 widths (768 wide, 12 heads of 64, patch 32,
  224^2) cut to 2 layers: per-row cosine >= 0.999 and max |err| <= 0.005
  on unit-norm embeddings of 512 dims (entries up to 0.14).  Both packages
  round every product, bias add, layer norm and residual add to bfloat16,
  at places one ulp apart.  Measured on the CPU with these seeds: max
  |err| 0.0014 (einsum) and 0.0011 (fused), cosine >= 0.99996.
"""
import dataclasses
import os

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.models import checkpoint as jck  # noqa: E402
from vidgraph_tpu.models import vit as jvit  # noqa: E402
from vidgraph_tpu_torch.convert import vit_params_from_jax  # noqa: E402
from vidgraph_tpu_torch.models import checkpoint as tck  # noqa: E402
from vidgraph_tpu_torch.models import vit as tvit  # noqa: E402


def port_cfg(jcfg) -> tvit.ViTConfig:
    dtype = {jnp.float32: torch.float32,
             jnp.bfloat16: torch.bfloat16}[jcfg.dtype]
    return tvit.ViTConfig(
        image_size=jcfg.image_size, patch_size=jcfg.patch_size,
        width=jcfg.width, layers=jcfg.layers, heads=jcfg.heads,
        embed_dim=jcfg.embed_dim, mlp_ratio=jcfg.mlp_ratio, dtype=dtype,
        attn_impl=jcfg.attn_impl)


def _towers(jcfg, seed=0):
    model, params = jvit.init_vision_tower(jcfg, seed)
    tower = tvit.VisionTower(port_cfg(jcfg))
    tower.load_state_dict(vit_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return model, params, tower


def _images(jcfg, b, seed):
    return np.random.default_rng(seed).normal(
        size=(b, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)


def test_configs_match():
    assert tvit.ViTConfig.tiny() == port_cfg(jvit.ViTConfig.tiny())
    assert tvit.ViTConfig.b32() == port_cfg(jvit.ViTConfig.b32())
    assert tvit.ViTConfig.b32().num_patches == 49


def test_param_names_and_shapes_are_flaxs():
    jcfg = jvit.ViTConfig.tiny()
    _, params = jvit.init_vision_tower(jcfg, 0)
    flat = {"/".join(str(p.key) for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    tower = tvit.init_vision_tower(port_cfg(jcfg))
    mine = {"params/" + k.replace(".", "/"): tuple(v.shape)
            for k, v in tower.state_dict().items()}
    assert mine == flat


@pytest.mark.parametrize("impl", ["einsum", "packed", "fused"])
def test_tiny_f32_embeddings(impl):
    jcfg = dataclasses.replace(jvit.ViTConfig.tiny(), attn_impl=impl)
    model, params, tower = _towers(jcfg, seed=1)
    img = _images(jcfg, 3, 2)
    ref = np.asarray(model.apply(params, jnp.asarray(img)))
    with torch.no_grad():
        got = tower(torch.from_numpy(img))
    assert got.dtype == torch.float32 and got.shape == (3, jcfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_tiny_f32_tokens():
    jcfg = jvit.ViTConfig.tiny()
    model, params, tower = _towers(jcfg, seed=3)
    img = _images(jcfg, 2, 4)
    ref = np.asarray(model.apply(params, jnp.asarray(img),
                                 return_tokens=True))
    with torch.no_grad():
        got = tower(torch.from_numpy(img), return_tokens=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["einsum", "fused"])
def test_bf16_b32_widths(impl):
    jcfg = dataclasses.replace(jvit.ViTConfig.b32(), layers=2,
                               attn_impl=impl)
    model, params, tower = _towers(jcfg, seed=5)
    img = _images(jcfg, 2, 6)
    ref = np.asarray(model.apply(params, jnp.asarray(img)))
    with torch.no_grad():
        got = tower(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 512) and np.isfinite(got).all()
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1)
                                 * np.linalg.norm(ref, axis=-1))
    assert cos.min() >= 0.999, cos
    assert np.abs(got - ref).max() <= 0.005


def test_weights_cross_through_a_jax_npz(tmp_path):
    """The Flax tree saved by the JAX package's checkpoint writer loads
    into the port bit for bit, through the port's reader."""
    jcfg = jvit.ViTConfig.tiny()
    _, params = jvit.init_vision_tower(jcfg, 7)
    path = jck.save_params({"vit": params}, str(tmp_path / "vit.npz"))
    tower = tvit.init_vision_tower(port_cfg(jcfg))
    loaded = tck.load_params({"vit": tvit.param_tree(tower)}, path)
    tower.load_state_dict(tvit.state_dict_from_tree(loaded["vit"]))
    flat = {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    for name, t in tower.state_dict().items():
        want = flat["params/" + name.replace(".", "/")]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), want)


def test_port_tree_round_trips_through_its_npz(tmp_path):
    tower = tvit.init_vision_tower(tvit.ViTConfig.tiny(),
                                   1)
    path = tck.save_params({"vit": tvit.param_tree(tower)},
                           str(tmp_path / "t.npz"))
    other = tvit.init_vision_tower(tvit.ViTConfig.tiny())
    loaded = tck.load_params({"vit": tvit.param_tree(other)}, path)
    other.load_state_dict(tvit.state_dict_from_tree(loaded["vit"]))
    for (n1, a), (n2, b) in zip(tower.state_dict().items(),
                                other.state_dict().items()):
        assert n1 == n2 and torch.equal(a, b)


def test_odd_heads_take_the_einsum_path():
    cfg = dataclasses.replace(tvit.ViTConfig.tiny(), width=48, heads=3,
                              attn_impl="fused")
    tower = tvit.init_vision_tower(cfg)
    from vidgraph_tpu_torch.ops import short_attention as tsa
    tsa.reset_counts()
    with torch.no_grad():
        out = tower(torch.randn(1, 64, 64, 3))
    assert out.shape == (1, 32) and tsa.REF_CALLS == 0
