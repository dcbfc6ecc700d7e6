"""The port's int8 ViT path (``models/vit_quant.py``) against the JAX
package's, on the CPU: the Flax tower's weights carried across by
``convert.vit_params_from_jax``, images from a numpy seed.

Tolerances: the quantised kernels and scales equal exactly; the embeddings
within 1e-4 of the JAX function's (unit-norm rows; the same arithmetic,
where a float32 activation on a rounding boundary may quantise the other
way); per-row cosine against the float tower above 0.995, the JAX
package's own bound (``tests/test_models.py``).
"""
import os

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.models import vit as jvit  # noqa: E402
from vidgraph_tpu.models import vit_quant as jvq  # noqa: E402
from vidgraph_tpu_torch.convert import vit_params_from_jax  # noqa: E402
from vidgraph_tpu_torch.models import vit as tvit  # noqa: E402
from vidgraph_tpu_torch.models import vit_quant as tvq  # noqa: E402


@pytest.fixture(scope="module")
def towers():
    jcfg = jvit.ViTConfig(image_size=64, patch_size=32, width=64, layers=2,
                          heads=2, embed_dim=32, dtype=jnp.float32)
    model, params = jvit.init_vision_tower(jcfg, seed=0)
    tcfg = tvit.ViTConfig(image_size=64, patch_size=32, width=64, layers=2,
                          heads=2, embed_dim=32, dtype=torch.float32)
    tower = tvit.VisionTower(tcfg)
    tower.load_state_dict(vit_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, model, params, tcfg, tower.eval()


def test_quantised_tower_equals_jax(towers):
    jcfg, _, params, tcfg, tower = towers
    jq = jvq.quantize_vit_params(params, jcfg)
    tq = tvq.quantize_vit_params(tvit.param_tree(tower), tcfg)
    assert set(tq) == {"_f32", "_q"}
    assert set(tq["_q"]) == set(jq["_q"])
    assert set(tq["_f32"]) == set(jq["_f32"])
    for name, (q, s, b) in tq["_q"].items():
        jqw, js, jb = jq["_q"][name]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqw))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


@pytest.mark.parametrize("batch,seed", [(3, 0), (1, 1), (5, 2)])
def test_vit_forward_int8_equals_jax(towers, batch, seed):
    jcfg, model, params, tcfg, tower = towers
    imgs = np.random.default_rng(seed).normal(
        size=(batch, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jvq.vit_forward_int8(
        jvq.quantize_vit_params(params, jcfg), jcfg, jnp.asarray(imgs)))
    got = tvq.vit_forward_int8(
        tvq.quantize_vit_params(tvit.param_tree(tower), tcfg), tcfg,
        torch.from_numpy(imgs))
    assert got.dtype == torch.float32 and got.shape == (batch, 32)
    assert np.abs(got.numpy() - ref).max() <= 1e-4
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0,
                               atol=1e-5)


def test_int8_tower_close_to_the_float_tower(towers):
    _, _, _, tcfg, tower = towers
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        ref = tower(imgs)
    got = tvq.vit_forward_int8(
        tvq.quantize_vit_params(tvit.param_tree(tower), tcfg), tcfg, imgs)
    cos = (ref * got).sum(dim=1)
    assert float(cos.min()) > 0.995, cos
