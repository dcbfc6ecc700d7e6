"""Training over a mesh, expert and pipeline parallelism: the port on 4
gloo ranks against the JAX package on the conftest's virtual devices.

One gloo group serves the module (``torch_parallel_cases.train_moe_
pipeline_cases``).  Criteria:

* ``TrainState`` on a (2, 2) (data, model) mesh at ``_dryrun_impl``'s
  shapes and ``TrainState``'s default learning rate (``LR``), from the
  JAX ``TrainState``'s weights on a (2, 2) CPU mesh:
  the losses of steps 1-3 and every leaf after steps 1 and 3 within
  1e-5 (float32);
* MoE: the sharded FFN within 1e-5 of JAX's ``moe_ffn`` on the same
  params; more than one expert used; the gradient of mean(y^2) finite
  and within 1e-5 of the unsharded autograd's and of ``jax.grad``'s;
* GPipe: (stages, micro) in {(2, 2), (4, 4), (2, 4)} within 2e-4 of
  the sequential stack and of JAX's ``pipeline_forward``; the gradient
  of mean(y^2) within 1e-4 of the sequential autograd's; invalid shapes
  raise ``ValueError``.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from vidgraph_tpu.models import captioner as jcap
from vidgraph_tpu.models.tokenizer import batch_encode
from vidgraph_tpu.models.train import TrainState as JTrainState
from vidgraph_tpu.models.vit import ViTConfig as JViT
from vidgraph_tpu.parallel import moe as jmoe
from vidgraph_tpu.parallel import pipeline as jpipe
from vidgraph_tpu_torch.parallel.launch import run_ranks

TESTS = str(Path(__file__).parent)
VIT = dict(image_size=64, patch_size=32, width=64, layers=2, heads=2,
           embed_dim=32)
CAP = dict(width=64, layers=2, heads=2, vision_dim=32, num_vision_tokens=2,
           max_len=32)
# TrainState's default rate.  At the dry-run's 1e-3, Adam's first update
# of a leaf whose gradient is near eps (the ViT's qkv bias and first
# layers) moves with the last float32 digits of that gradient by ~2e-5
# on one device as well, which is no property of the mesh
# (tests/test_torch_train.py::test_three_train_steps_match_jax)
LR = 1e-4
PIPE_CFG = dict(width=32, layers=4, heads=2, vision_dim=32,
                num_vision_tokens=2, max_len=16)


def _numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree)}


def _devices(n):
    return [d for d in jax.devices() if d.platform == "cpu"][:n]


def _train_side():
    mesh = Mesh(np.asarray(_devices(4)).reshape(2, 2), ("data", "model"))
    state = JTrainState.create(JViT(**VIT, dtype=jnp.float32),
                               jcap.CaptionerConfig(**CAP,
                                                    dtype=jnp.float32),
                               mesh, learning_rate=LR)
    init = _numpy(state.params)
    rng = np.random.default_rng(0)
    images = rng.normal(size=(4, 64, 64, 3)).astype(np.float32)
    tokens = batch_encode(["a tiny training caption"] * 4, 16)
    batch = state.shard_batch(images, tokens)
    losses, trees = [], {}
    for step in (1, 2, 3):
        state, loss = state.step(*batch)
        losses.append(loss)
        if step in (1, 3):
            trees[step] = _numpy(state.params)
    inputs = {"lr": LR, "vit_cfg": VIT, "cap_cfg": CAP, "vit": init["vit"],
              "cap": init["cap"], "images": images, "tokens": tokens}
    return inputs, {"losses": losses, "trees": trees}


def _moe_side():
    fwd_params = jmoe.init_moe_params(jax.random.PRNGKey(0), d_model=32,
                                      d_hidden=64, n_experts=4)
    fwd_x = jax.random.normal(jax.random.PRNGKey(1), (2, 8, 32))
    route_params = jmoe.init_moe_params(jax.random.PRNGKey(2), d_model=16,
                                        d_hidden=32, n_experts=4)
    route_x = jax.random.normal(jax.random.PRNGKey(3), (4, 32, 16))
    grad_params = jmoe.init_moe_params(jax.random.PRNGKey(4), d_model=16,
                                       d_hidden=32, n_experts=2)
    grad_x = jax.random.normal(jax.random.PRNGKey(5), (2, 4, 16))
    grads = jax.grad(lambda p: jnp.mean(jmoe.moe_ffn(p, grad_x) ** 2))(
        grad_params)
    inputs = {"fwd_params": _numpy(fwd_params), "fwd_x": np.array(fwd_x),
              "route_params": _numpy(route_params),
              "route_x": np.array(route_x),
              "grad_params": _numpy(grad_params),
              "grad_x": np.array(grad_x)}
    return inputs, {"fwd": np.array(jmoe.moe_ffn(fwd_params, fwd_x)),
                    "grad": _numpy(grads)}


def _pipeline_side():
    cfg = jcap.CaptionerConfig(**PIPE_CFG, dtype=jnp.float32)
    params = jcap.init_params(cfg, seed=0)
    x = np.random.default_rng(0).normal(size=(8, 8, 32)).astype(np.float32)
    idx = jnp.arange(8)
    mask = jnp.where(idx[None, :] <= idx[:, None], 0.0, -1e30)
    fwd = {}
    for stages, micro in ((2, 2), (4, 4), (2, 4)):
        mesh = Mesh(np.asarray(_devices(stages)), ("pipe",))
        fwd[(stages, micro)] = np.array(jpipe.pipeline_forward(
            jpipe.captioner_block_fn(cfg, mask),
            jpipe.stack_block_params(params["blocks"]), jnp.asarray(x),
            mesh, n_microbatches=micro))
    gcfg = jcap.CaptionerConfig(**{**PIPE_CFG, "layers": 2},
                                dtype=jnp.float32)
    grad_params = jcap.init_params(gcfg, seed=1)
    grad_x = np.random.default_rng(1).normal(size=(4, 8, 32)).astype(
        np.float32)
    inputs = {"params": _numpy(params), "x": x,
              "grad_params": _numpy(grad_params), "grad_x": grad_x}
    return inputs, {"fwd": fwd}


@pytest.fixture(scope="module")
def runs():
    train_in, train_jax = _train_side()
    moe_in, moe_jax = _moe_side()
    pipe_in, pipe_jax = _pipeline_side()
    port = run_ranks("torch_parallel_cases:train_moe_pipeline_cases", 4,
                     ({"train": train_in, "moe": moe_in,
                       "pipeline": pipe_in},), pythonpath=[TESTS],
                     deadline_s=240.0)
    return {"train": train_jax, "moe": moe_jax, "pipeline": pipe_jax}, port


@pytest.mark.parametrize("steps", [1, 3])
def test_train_state_on_a_2x2_mesh_equals_jax(runs, steps):
    jax_side, port = runs
    got = port[0]["train"]
    np.testing.assert_allclose(got["losses"][:steps],
                               jax_side["train"]["losses"][:steps],
                               atol=1e-5, rtol=0)
    want = _flat(jax_side["train"]["trees"][steps])
    have = _flat(got["trees"][steps])
    assert sorted(have) == sorted(want)
    worst = max(float(np.abs(have[k] - want[k]).max()) for k in want)
    assert worst < 1e-5, worst


def test_train_state_ranks_hold_their_slices(runs):
    """Every rank reports the same losses; each holds half the heads of
    the first block's q, k and v and half the batch's rows."""
    port = runs[1]
    losses = [rank["train"]["losses"] for rank in port]
    assert all(lo == losses[0] for lo in losses)
    for rank in port:
        assert rank["train"]["local"]["qkv_w"] == (64, 3 * 64 // 2)
        assert rank["train"]["local"]["rows"] == (2, 64, 64, 3)


def test_moe_sharded_matches_unsharded_and_jax(runs):
    jax_side, port = runs
    whole, sharded, local_shape = port[0]["moe"]["fwd"]
    assert local_shape == (1, 32, 64)          # one expert of 4 a rank
    np.testing.assert_allclose(sharded, whole, atol=1e-5, rtol=0)
    np.testing.assert_allclose(sharded, jax_side["moe"]["fwd"], atol=1e-5,
                               rtol=1e-5)


def test_moe_routing_uses_multiple_experts(runs):
    assert runs[1][0]["moe"]["experts_used"] > 1


def test_moe_gradient_equals_unsharded_and_jax(runs):
    jax_side, port = runs
    whole, sharded = port[0]["moe"]["grad"]
    for k in whole:
        assert np.isfinite(sharded[k]).all()
        np.testing.assert_allclose(sharded[k], whole[k], atol=1e-5, rtol=0)
        np.testing.assert_allclose(whole[k], jax_side["moe"]["grad"][k],
                                   atol=1e-5, rtol=0)
    assert any(np.abs(g).sum() > 0 for g in sharded.values())


@pytest.mark.parametrize("n_stages,n_micro", [(2, 2), (4, 4), (2, 4)])
def test_pipeline_matches_sequential_and_jax(runs, n_stages, n_micro):
    jax_side, port = runs
    got = port[0]["pipeline"]["fwd"][(n_stages, n_micro)]
    np.testing.assert_allclose(got, port[0]["pipeline"]["seq"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(
        got, jax_side["pipeline"]["fwd"][(n_stages, n_micro)], rtol=2e-4,
        atol=2e-4)


def test_pipeline_gradient_equals_sequential(runs):
    piped, seq = runs[1][0]["pipeline"]["grad"]
    assert sorted(piped) == sorted(seq)
    for k in seq:
        assert np.isfinite(piped[k]).all()
        np.testing.assert_allclose(piped[k], seq[k], atol=1e-4, rtol=0)
    assert any(np.abs(g).sum() > 0 for g in piped.values())


def test_pipeline_invalid_shapes_raise(runs):
    blocks_err, micro_err = runs[1][0]["pipeline"]["invalid"]
    assert blocks_err and "blocks 3 % stages 2" in blocks_err
    assert micro_err and "batch 4 % microbatches 3" in micro_err
