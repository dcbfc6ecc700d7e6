"""The port's training path against the JAX package's, on the CPU.

Weights are the JAX package's seed weights carried across with
``convert.py``; inputs are made from numpy seeds.  Tolerances:

* gradients of the mean next-token cross entropy over ``forward``, every
  leaf: float32 ``tiny`` max |diff| / max |ref| < 1e-4 (the same float32
  arithmetic in another summation order); the bfloat16 2-layer width-512
  config < 5e-2 (the JAX package's own limit for its flash-vs-einsum
  gradients on the chip, ``tests/test_flash_attention.py``: both sides
  round every product to bfloat16 at places that differ);
* ``remat=True`` against ``remat=False``: 1e-6 (the same operations,
  recomputed);
* ``caption_loss`` within 1e-5; three ``TrainState`` steps from the same
  weights and batch: losses and every parameter within 1e-5 of the JAX
  ``TrainState`` on a one-device mesh;
* the schedule within 1e-7 of ``optax.warmup_cosine_decay_schedule`` at
  every step, the clip within 1e-6 of ``optax.clip_by_global_norm``.
"""
import os

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.models import captioner as jcap  # noqa: E402
from vidgraph_tpu.models import train as jtrain  # noqa: E402
from vidgraph_tpu.models import vit as jvit  # noqa: E402
from vidgraph_tpu.models.tokenizer import batch_encode  # noqa: E402
from vidgraph_tpu.parallel.mesh import build_mesh  # noqa: E402
from vidgraph_tpu_torch.convert import (captioner_params_from_jax,  # noqa: E402
                                        to_numpy_tree, vit_params_from_jax)
from vidgraph_tpu_torch.models import captioner as tcap  # noqa: E402
from vidgraph_tpu_torch.models import checkpoint as tck  # noqa: E402
from vidgraph_tpu_torch.models import train as ttrain  # noqa: E402
from vidgraph_tpu_torch.models import vit as tvit  # noqa: E402

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _cap_cfg(jcfg) -> tcap.CaptionerConfig:
    return tcap.CaptionerConfig(
        width=jcfg.width, layers=jcfg.layers, heads=jcfg.heads,
        vocab=jcfg.vocab, vision_dim=jcfg.vision_dim,
        num_vision_tokens=jcfg.num_vision_tokens, max_len=jcfg.max_len,
        dtype=_DTYPES[jcfg.dtype])


def _vit_cfg(jcfg) -> tvit.ViTConfig:
    return tvit.ViTConfig(
        image_size=jcfg.image_size, patch_size=jcfg.patch_size,
        width=jcfg.width, layers=jcfg.layers, heads=jcfg.heads,
        embed_dim=jcfg.embed_dim, mlp_ratio=jcfg.mlp_ratio,
        dtype=_DTYPES[jcfg.dtype], attn_impl=jcfg.attn_impl)


def _flat(tree) -> dict:
    """{'/'-joined path: numpy leaf} of a JAX tree."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _lm_inputs(jcfg, b, t, seed):
    rng = np.random.default_rng(seed)
    vis = rng.normal(size=(b, jcfg.num_vision_tokens,
                           jcfg.vision_dim)).astype(np.float32)
    toks = rng.integers(0, 256, (b, t + 1)).astype(np.int32)
    return vis, toks


def _jax_lm_loss(p, jcfg, vis, toks, remat=False):
    logits = jcap.forward(p, jcfg, vis, toks[:, :-1], remat=remat)
    ce = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                         toks[:, 1:])
    return ce.mean()


def _port_lm_grads(tp, tcfg, vis, toks, remat=False, flash=False):
    tcap.trainable(tp)
    toks = torch.from_numpy(toks)
    logits = tcap.forward(tp, tcfg, torch.from_numpy(vis),
                          toks[:, :-1].long(), remat=remat, flash=flash)
    loss = ttrain.masked_cross_entropy(
        logits, toks[:, 1:], torch.ones_like(toks[:, 1:], dtype=torch.bool))
    loss.backward()
    return loss.item(), {k: p.grad.numpy() for k, p
                         in tck.tree_leaves(tp)}


@pytest.mark.parametrize("name,jcfg,limit", [
    ("tiny_f32", jcap.CaptionerConfig.tiny(), 1e-4),
    ("bf16_w512", jcap.CaptionerConfig(width=512, layers=2, heads=8,
                                       max_len=64), 5e-2),
])
def test_forward_gradients_match_jax_grad(name, jcfg, limit):
    jp = jcap.init_params(jcfg, seed=1)
    tp = captioner_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    vis, toks = _lm_inputs(jcfg, 2, 20, 11)
    jloss, jgrads = jax.value_and_grad(_jax_lm_loss)(jp, jcfg, vis, toks)
    tloss, tgrads = _port_lm_grads(tp, _cap_cfg(jcfg), vis, toks)
    assert abs(tloss - float(jloss)) < (1e-5 if limit < 1e-3 else 2e-2)
    jflat = _flat(jgrads)
    assert set(jflat) == set(tgrads)
    for key, ref in jflat.items():
        scale = max(float(np.abs(ref).max()), 1e-12)
        rel = float(np.abs(tgrads[key] - ref).max()) / scale
        assert rel < limit, (key, rel)


def test_remat_gives_the_same_loss_and_gradients():
    jcfg = jcap.CaptionerConfig.tiny()
    vis, toks = _lm_inputs(jcfg, 2, 20, 5)
    runs = []
    for remat in (False, True):
        tp = tcap.init_params(_cap_cfg(jcfg),
                              2)
        runs.append(_port_lm_grads(tp, _cap_cfg(jcfg), vis, toks,
                                   remat=remat))
    (l0, g0), (l1, g1) = runs
    assert abs(l0 - l1) < 1e-6
    for key in g0:
        np.testing.assert_allclose(g1[key], g0[key], atol=1e-6, rtol=0,
                                   err_msg=key)


def test_remat_matches_jax_checkpoint():
    """``remat=True`` in both packages: the same gradients (1e-4 of the
    leaf's max, float32)."""
    jcfg = jcap.CaptionerConfig.tiny()
    jp = jcap.init_params(jcfg, seed=4)
    tp = captioner_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    vis, toks = _lm_inputs(jcfg, 2, 20, 6)
    jgrads = _flat(jax.grad(_jax_lm_loss)(jp, jcfg, vis, toks, True))
    _, tgrads = _port_lm_grads(tp, _cap_cfg(jcfg), vis, toks, remat=True)
    for key, ref in jgrads.items():
        rel = float(np.abs(tgrads[key] - ref).max()) / max(
            float(np.abs(ref).max()), 1e-12)
        assert rel < 1e-4, (key, rel)


# the configs of tests/test_train.py
J_VIT = jvit.ViTConfig(image_size=64, patch_size=32, width=64, layers=2,
                       heads=2, embed_dim=32, dtype=jnp.float32)
J_CAP = jcap.CaptionerConfig(width=64, layers=2, heads=2, vision_dim=32,
                             num_vision_tokens=2, max_len=32,
                             dtype=jnp.float32)


def _states(lr=1e-4):
    """(JAX TrainState on a one-device mesh, the port's over the same
    weights)."""
    mesh = build_mesh(jax.devices()[:1], model_axis=1)
    jstate = jtrain.TrainState.create(J_VIT, J_CAP, mesh, learning_rate=lr)
    host = jax.tree_util.tree_map(np.asarray, jstate.params)
    tower = tvit.VisionTower(_vit_cfg(J_VIT))
    tower.load_state_dict(vit_params_from_jax(host["vit"]))
    cap = captioner_params_from_jax(host["cap"])
    tstate = ttrain.TrainState.from_models(tower, cap, _vit_cfg(J_VIT),
                                           _cap_cfg(J_CAP), learning_rate=lr)
    return jstate, tstate


def _batch(seed, text):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
    return images, batch_encode([text] * 6 + [text[:5], text + " moves"], 16)


def test_caption_loss_matches_jax():
    jstate, tstate = _states()
    images, tokens = _batch(7, "a green circle")
    with jstate.mesh:
        want = float(jtrain.caption_loss(
            jstate.vit, jstate.params["vit"], jstate.params["cap"], J_CAP,
            jnp.asarray(images), jnp.asarray(tokens)))
    got = ttrain.caption_loss(tstate.vit, tstate.params["cap"],
                              tstate.cap_cfg, *tstate.shard_batch(images,
                                                                  tokens))
    assert abs(got.item() - want) < 1e-5


def test_three_train_steps_match_jax():
    """At ``TrainState``'s default learning rate, 1e-4: Adam divides a
    gradient by its own magnitude, so where a gradient is small against
    eps (the ViT's qkv bias) a float32 difference in the last digits moves
    the update by about a hundredth of the learning rate."""
    jstate, tstate = _states()
    images, tokens = _batch(0, "a red square")
    jbatch = jstate.shard_batch(images, tokens)
    tbatch = tstate.shard_batch(images, tokens)
    for step in range(3):
        jstate, jloss = jstate.step(*jbatch)
        tstate, tloss = tstate.step(*tbatch)
        assert abs(tloss - jloss) < 1e-5, (step, tloss, jloss)
    want = _flat(jstate.params)
    got = _flat(to_numpy_tree(tstate.checkpoint_tree()))
    assert set(got) == set(want)
    for key, ref in want.items():
        np.testing.assert_allclose(got[key], ref, atol=1e-5, rtol=0,
                                   err_msg=key)


def test_loss_decreases_overfitting_one_batch():
    """The JAX package's overfit test (``tests/test_train.py``) on the
    port's own seed weights."""
    state = ttrain.TrainState.create(_vit_cfg(J_VIT), _cap_cfg(J_CAP),
                                     torch.device("cpu"), learning_rate=1e-3)
    rng = np.random.default_rng(0)
    images = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
    batch = state.shard_batch(images, batch_encode(["a red square"] * 8, 16))
    losses = []
    for _ in range(8):
        state, loss = state.step(*batch)
        losses.append(loss)
    assert losses[-1] < losses[0] * 0.8, losses


@pytest.mark.parametrize("mesh", [2, [0, 1, 2, 3]])
def test_a_mesh_wider_than_one_device_raises(mesh):
    """``TrainState.create`` takes a mesh (it raised before the port had
    meshes): over this process's world of one, a mesh built with
    ``model_axis=2`` or over ranks ``[0]`` is (1, 1), and three steps
    equal the one-device state's (same seed, same batch).  The mesh
    arithmetic of wider worlds is ``tests/test_torch_parallel_*.py``'s."""
    from vidgraph_tpu_torch.parallel import mesh as pmesh

    try:
        built = (pmesh.build_mesh(model_axis=mesh) if isinstance(mesh, int)
                 else pmesh.build_mesh(ranks=mesh[:1]))
        assert tuple(built.shape) == (1, 1)
        states = [ttrain.TrainState.create(
            _vit_cfg(J_VIT), _cap_cfg(J_CAP), torch.device("cpu"), mesh=m)
            for m in (built, None)]
        assert states[0].mesh is built and states[1].mesh is None
        batch = _batch(3, "a blue line")
        for _ in range(3):
            losses = [st.step(*st.shard_batch(*batch))[1] for st in states]
            assert losses[0] == losses[1]
    finally:
        pmesh.shutdown()


def test_fused_vit_attention_trains_on_the_cpu_plain_version():
    """On the CPU ``attn_impl='fused'`` is the plain version, which
    autograd differentiates; the card's kernel raises under autograd
    (``tests/test_torch_cuda_flash_attention.py``)."""
    import dataclasses

    cfg = dataclasses.replace(_vit_cfg(J_VIT), attn_impl="fused")
    tower = tvit.init_vision_tower(cfg)
    x = torch.from_numpy(_batch(1, "x")[0][:2])
    tower(x).sum().backward()
    assert tower.block_0.attn.qkv.kernel.grad.abs().max() > 0


@pytest.mark.parametrize("args", [
    (0.0, 5e-4, 5, 50, 2.5e-5),       # the instruct trainer's shape
    (0.0, 3e-4, 1, 12, 3e-5),         # the mid-scale trainer at 12 steps
    (1e-5, 1e-3, 10, 30, 0.0),        # the decay ends before the run does
])
def test_schedule_matches_optax(args):
    init, peak, warmup, decay, end = args
    want = optax.warmup_cosine_decay_schedule(
        init, peak, warmup_steps=warmup, decay_steps=decay, end_value=end)
    got = ttrain.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    for step in range(50):
        assert abs(got(step) - float(want(step))) < 1e-7, step


@pytest.mark.parametrize("scale", [0.01, 3.0])
def test_clip_by_global_norm_matches_optax(scale):
    """A norm below 1 (left as it is) and above 1 (scaled to 1)."""
    rng = np.random.default_rng(1)
    grads = {"a": (rng.normal(size=(4, 5)) * scale).astype(np.float32),
             "b": [(rng.normal(size=(7,)) * scale).astype(np.float32)]}
    norm = float(optax.global_norm(grads))
    assert (norm < 1.0) == (scale < 1.0)
    tx = optax.clip_by_global_norm(1.0)
    want, _ = tx.update(grads, tx.init(grads))
    got = [torch.from_numpy(grads["a"].copy()),
           torch.from_numpy(grads["b"][0].copy())]
    got_norm = ttrain.clip_by_global_norm(got, 1.0)
    assert abs(float(got_norm) - norm) < 1e-6
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want["a"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want["b"][0]),
                               atol=1e-6, rtol=0)


def test_adamw_with_clip_and_schedule_matches_optax_chain():
    """Three updates of ``AdamW(max_norm=1, schedule)`` against
    ``optax.chain(clip_by_global_norm(1), adamw(schedule, 0.01))`` from the
    same parameters and gradients, within 1e-6."""
    rng = np.random.default_rng(2)
    p0 = {"w": rng.normal(size=(6, 4)).astype(np.float32),
          "blocks": [{"b": rng.normal(size=(4,)).astype(np.float32)}]}
    sched = (0.0, 1e-2, 2, 10, 1e-3)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(
            sched[0], sched[1], warmup_steps=sched[2], decay_steps=sched[3],
            end_value=sched[4]), weight_decay=0.01))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jo = tx.init(jp)
    tp = tcap.trainable(captioner_params_from_jax(p0))
    opt = ttrain.AdamW(tp, ttrain.warmup_cosine_decay_schedule(*sched),
                       weight_decay=0.01, max_norm=1.0)
    for step in range(3):
        g = {"w": (rng.normal(size=(6, 4)) * (3.0 if step else 0.05)
                   ).astype(np.float32),
             "blocks": [{"b": rng.normal(size=(4,)).astype(np.float32)}]}
        updates, jo = tx.update(jax.tree_util.tree_map(jnp.asarray, g), jo,
                                jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        tp["w"].grad = torch.from_numpy(g["w"].copy())
        tp["blocks"][0]["b"].grad = torch.from_numpy(
            g["blocks"][0]["b"].copy())
        opt.update()
    np.testing.assert_allclose(tp["w"].detach().numpy(), np.asarray(jp["w"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tp["blocks"][0]["b"].detach().numpy(),
                               np.asarray(jp["blocks"][0]["b"]), atol=1e-6,
                               rtol=0)


def test_adamw_state_round_trips(tmp_path):
    """``state_tree`` -> npz -> ``load_state_tree`` continues as the
    uninterrupted optimiser does."""
    from vidgraph_tpu_torch.models.checkpoint import load_params, save_params

    def fresh():
        p = tcap.trainable({"w": torch.ones(3, 2), "blocks": [
            {"b": torch.full((2,), 0.5)}]})
        return p, ttrain.AdamW(p, 1e-2, max_norm=1.0)

    def step(p, opt, k):
        opt.zero_grad()
        (p["w"].sum() * k + (p["blocks"][0]["b"] ** 2).sum()).backward()
        opt.update()

    pa, oa = fresh()
    for k in (1.0, 2.0, 3.0):
        step(pa, oa, k)
    pb, ob = fresh()
    step(pb, ob, 1.0)
    save_params({"params": pb, "opt": ob.state_tree()},
                str(tmp_path / "s.npz"))
    pc, oc = fresh()
    state = load_params({"params": pc, "opt": oc.state_tree()},
                        str(tmp_path / "s.npz"))
    with torch.no_grad():
        for (_, dst), (_, src) in zip(tck.tree_leaves(pc),
                                      tck.tree_leaves(state["params"])):
            dst.copy_(src)
    oc.load_state_tree(state["opt"])
    assert oc.count == 1
    for k in (2.0, 3.0):
        step(pc, oc, k)
    for (key, a), (_, c) in zip(tck.tree_leaves(pa),
                                tck.tree_leaves(pc)):
        torch.testing.assert_close(c, a, atol=1e-7, rtol=0, msg=key)
