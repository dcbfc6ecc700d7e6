"""The port's encoder trainers (``scripts/train_torch_{reranker,
answer_selector,text_embedder}.py``) on the CPU, against the JAX
package's (``scripts/train_{reranker,answer_selector,text_embedder}.py``,
imported by path).

* Each data-building function gives data equal to the JAX script's for
  the same seed and corpus (the golden vlm output plus synthetic
  captions); the reranker's cosine prior within 1e-6.
* Each loss, and updates from the same JAX-drawn weights and batch
  (``convert.py``), within 1e-5 in float32 of the JAX script's
  arithmetic, written out here since the scripts build it inside
  ``main``: the clipped, scheduled AdamW of the reranker and the
  selector, the unclipped AdamW on a cosine decay of the embedder.  The
  embedder also in bfloat16: the loss within ``BF16_LOSS_TOL`` of the
  JAX script's bfloat16 loss, the first step's gradient of each leaf
  within ``BF16_GRAD_TOL`` of its norm of the JAX script's float32
  gradient.
* Each ``main([... "--device", "cpu"])`` at a small size in a temp dir:
  the loss falls (the mean of the last quarter of the steps below the
  first quarter's; the selector's 8-step smoke instead logs the JAX
  script's losses, which from the same seed weights do not fall), the
  npz loads with the JAX package's ``load_params``
  bit for bit, the sidecar has the JAX script's keys, and the checkpoint
  serves in both packages' serving classes within 1e-5 (float32).
"""
import dataclasses
import importlib.util
import json
import os
import random
import re
import sys
from pathlib import Path

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.models import answer_selector as jsel  # noqa: E402
from vidgraph_tpu.models import captioner as jcap  # noqa: E402
from vidgraph_tpu.models import checkpoint as jck  # noqa: E402
from vidgraph_tpu.models import instruct_data as jdata  # noqa: E402
from vidgraph_tpu.models import reranker as jrr  # noqa: E402
from vidgraph_tpu.models import text_embedder as jte  # noqa: E402
from vidgraph_tpu.models import tokenizer as jtok  # noqa: E402
from vidgraph_tpu.services import embed_client as jec  # noqa: E402
from vidgraph_tpu_torch import convert  # noqa: E402
from vidgraph_tpu_torch.models import answer_selector as tsel  # noqa: E402
from vidgraph_tpu_torch.models import captioner as tcap  # noqa: E402
from vidgraph_tpu_torch.models import checkpoint as tck  # noqa: E402
from vidgraph_tpu_torch.models import instruct_data as tdata  # noqa: E402
from vidgraph_tpu_torch.models import reranker as trr  # noqa: E402
from vidgraph_tpu_torch.models import text_embedder as tte  # noqa: E402
from vidgraph_tpu_torch.models import train as ttrain  # noqa: E402
from vidgraph_tpu_torch.services import embed_client as tec  # noqa: E402

ROOT = Path(__file__).parent.parent
GOLDEN = ROOT / "tests" / "golden" / "vlm_output_golden.json"
F32_TOL = 1e-5
# the bf16 embedder against the JAX script's bf16 arithmetic: products
# round at other places in the two backends
BF16_LOSS_TOL = 2e-2
# the bf16 embedder's first-step gradient of a leaf against the JAX
# script's float32 gradient, |g - g_f32| / |g_f32| (the key third of
# ``qkv_b`` left out, ``_key_bias``): the port's is at most 0.0091 off at
# the test's widths, the JAX script's own bf16 gradient 0.006-0.36 (it
# sums the biases' gradients in bf16); a zero gradient is 1 off, a
# flipped one 2.  AdamW's update after a step, about lr x sign(gradient)
# a leaf, cannot tell them apart in bf16.
BF16_GRAD_TOL = 3e-2


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {name: _script(name) for name in (
        "train_reranker", "train_torch_reranker", "train_answer_selector",
        "train_torch_answer_selector", "train_text_embedder",
        "train_torch_text_embedder")}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory) -> Path:
    """The golden vlm output plus 40 synthetic captions, as a vlm_output
    (the reranker's hard negatives need more than 11 chunks)."""
    rng = random.Random(5)
    results = json.loads(GOLDEN.read_text())["results"]
    results = results + [
        {"content": " ".join(tdata.synth_sentence(rng) for _ in range(4))}
        for _ in range(40)]
    path = tmp_path_factory.mktemp("corpus") / "vlm_output.json"
    path.write_text(json.dumps({"results": results}))
    return path


def _chunks(corpus):
    data = json.loads(Path(corpus).read_text())
    return list(dict.fromkeys(r["content"] for r in data["results"]
                              if r.get("content")))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_leaves(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _key_bias(key, leaf):
    """The key third of a block's ``qkv_b``: a query's scores over the
    keys all move by q . b_k, which the softmax does not see, so its
    exact gradient is zero and AdamW scales rounding noise in its place
    to steps of up to lr, which differ between the two packages."""
    if key.endswith("qkv_b"):
        d = leaf.shape[0] // 3
        return np.r_[leaf[:d], leaf[2 * d:]]
    return leaf


def _assert_trees_close(tparams, jparams, atol, skip=()):
    want = _jax_leaves(jparams)
    got = dict(tck.tree_leaves(tparams))
    assert set(got) == set(want)
    for key, leaf in got.items():
        if key in skip:
            continue
        np.testing.assert_allclose(
            _key_bias(key, leaf.detach().float().numpy()),
            _key_bias(key, want[key]), atol=atol, rtol=0, err_msg=key)


def _assert_jax_loads_bit_for_bit(template, path):
    """``vidgraph_tpu.models.checkpoint.load_params`` reads the port's npz
    and gives the port's own ``load_params`` leaves, bit for bit."""
    jtree = jck.load_params(template, str(path))
    ttree = tck.load_params(convert.captioner_params_from_jax(
        _numpy_tree(template)), str(path))
    jleaves = _jax_leaves(jtree)
    tleaves = dict(tck.tree_leaves(ttree))
    assert set(jleaves) == set(tleaves) and tleaves
    for key, leaf in tleaves.items():
        a = jleaves[key]
        _, b = tck.to_numpy(leaf)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


def _falls(losses):
    q = max(1, len(losses) // 4)
    return np.mean(losses[-q:]) < np.mean(losses[:q])


# ---------------------------------------------------------- shared pieces
@pytest.mark.parametrize("lr,steps,alpha", [(3e-4, 600, 0.1), (1e-2, 7, 0.0),
                                            (5e-3, 1, 0.5)])
def test_cosine_decay_schedule_is_optax(lr, steps, alpha):
    want = optax.cosine_decay_schedule(lr, steps, alpha)
    got = ttrain.cosine_decay_schedule(lr, steps, alpha)
    for t in (0, 1, steps // 3, steps - 1, steps, steps + 5):
        assert abs(got(t) - float(want(t))) <= 1e-6 * lr, t  # optax: f32
    with pytest.raises(ValueError):
        ttrain.cosine_decay_schedule(lr, 0)


def test_needed_columns_keeps_the_last_real_byte():
    pad = jtok.PAD_ID
    toks = np.full((3, 2, 6), pad, np.int32)
    toks[0, 1, :4] = 7
    toks[1, 0, :1] = 7
    assert tte.needed_columns(toks).tolist() == [4, 1, 1]
    assert tte.needed_columns(toks[:, 0]).tolist() == [1, 1, 1]


# ---------------------------------------------------------------- reranker
@pytest.mark.parametrize("seed", [0, 3])
def test_reranker_data_equals_the_jax_script(scripts, corpus, seed):
    jm, tm = scripts["train_reranker"], scripts["train_torch_reranker"]
    chunks = _chunks(corpus)
    for q_rng_seed in range(3):
        for chunk in chunks[:8]:
            assert tm.queries_for(chunk, random.Random(q_rng_seed)) == \
                jm.queries_for(chunk, random.Random(q_rng_seed))
    want = jm.build_groups(chunks, random.Random(seed))
    got = tm.build_groups(chunks, random.Random(seed))
    assert got == want and len(got) > 100
    assert tm.synthetic_groups(random.Random(seed), 60) == \
        jm.synthetic_groups(random.Random(seed), 60)
    # the cosine prior, as the JAX script computes it inline in main
    groups = want[:40]
    ref_embed = jec.make_embed_client("tpu", dim=512)
    ref = np.zeros((len(groups), len(groups[0][1])), np.float32)
    for g, (q, docs, _) in enumerate(groups):
        vecs = ref_embed.embed([q] + list(docs))
        ref[g] = vecs[1:] @ vecs[0]
    sims = tm.cosine_prior(groups, tec.make_embed_client("tpu", dim=512))
    np.testing.assert_allclose(sims, ref, atol=1e-6, rtol=0)
    cfg = trr.RerankerConfig.tiny()
    for q, docs, _ in groups[:5]:
        np.testing.assert_array_equal(
            trr.batch_encode_pairs(q, docs, cfg),
            jrr.batch_encode_pairs(q, docs, jrr.RerankerConfig.tiny()))


def _reranker_batch(scripts, corpus, cfg_t, n_groups=3):
    tm = scripts["train_torch_reranker"]
    groups = tm.build_groups(_chunks(corpus), random.Random(1))[:n_groups]
    toks = np.stack([trr.batch_encode_pairs(q, d, cfg_t)
                     for q, d, _ in groups])
    pos = np.array([p for _, _, p in groups], np.int32)
    sims = tm.cosine_prior(groups, tec.make_embed_client("tpu", dim=512))
    return toks, pos, sims


def test_reranker_loss_and_updates_match_the_jax_arithmetic(scripts,
                                                            corpus):
    tm = scripts["train_torch_reranker"]
    # tiny widths at the default max_len, so that the batch has pad
    # columns for the step to drop
    shape = dict(width=32, layers=2, heads=2, max_len=512, query_budget=24)
    jcfg, tcfg = jrr.RerankerConfig(**shape), trr.RerankerConfig(**shape)
    toks, pos, sims = _reranker_batch(scripts, corpus, tcfg)
    lam, score_reg, lr, steps = 8.0, 0.02, 2e-3, 20
    warmup = min(100, max(1, steps // 10))

    def loss_fn(p, batch_toks, batch_pos, batch_sims):  # train_reranker.py
        g, d, t = batch_toks.shape
        scores = jrr.reranker_scores(p, jcfg,
                                     batch_toks.reshape(g * d, t)
                                     ).reshape(g, d)
        logits = scores + lam * batch_sims
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits, batch_pos).mean()
        return ce + score_reg * jnp.mean(jnp.square(scores))

    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=warmup, decay_steps=max(steps, warmup + 1),
        end_value=lr * 0.05)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=0.01))
    jp = jrr.init_reranker_params(jcfg, 2)
    jo = tx.init(jp)
    tp = tcap.trainable(convert.reranker_params_from_jax(_numpy_tree(jp)))
    opt = ttrain.AdamW(tp, ttrain.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(steps, warmup + 1), lr * 0.05),
        weight_decay=0.01, max_norm=1.0)
    t = int(tte.needed_columns(toks).max())
    assert t < toks.shape[-1], "the batch has pad columns to drop"
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    for step in range(3):
        jloss, grads = grad_fn(
            jp, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(sims))
        updates, jo = tx.update(grads, jo, jp)
        jp = optax.apply_updates(jp, updates)
        with torch.no_grad():     # the full width gives the trimmed loss
            full = tm.reranker_loss(tp, tcfg, torch.from_numpy(toks),
                                    torch.from_numpy(pos),
                                    torch.from_numpy(sims), lam, score_reg)
        opt.zero_grad()
        tloss = tm.reranker_loss(tp, tcfg, torch.from_numpy(toks[..., :t]),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(sims), lam, score_reg)
        tloss.backward()
        opt.update()
        assert abs(tloss.item() - float(jloss)) < F32_TOL, step
        assert abs(full.item() - float(jloss)) < F32_TOL, step
    _assert_trees_close(tp, jp, F32_TOL)


def test_reranker_trainer_runs_and_serves_in_both_packages(scripts, corpus,
                                                           tmp_path):
    tm = scripts["train_torch_reranker"]
    out = tmp_path / "reranker.npz"
    rec = tm.main(["--corpus", str(corpus), "--tiny", "--steps", "60",
                   "--synth-groups", "60", "--heldout", "12", "--lr", "3e-3",
                   "--device", "cpu", "--out", str(out)])
    assert rec["device"] == "cpu" and rec["peak_memory_gb"] is None
    assert len(rec["losses"]) == 60 and all(np.isfinite(rec["losses"]))
    assert _falls(rec["losses"]), rec["losses"]
    assert rec["heldout"]["n"] == 12 and 0 < rec["heldout"]["mrr"] <= 1
    meta = json.loads(out.with_suffix(".json").read_text())
    assert set(meta) == {"config", "steps", "final_loss", "cosine_lambda"}
    assert meta["config"] == "tiny" and meta["cosine_lambda"] == 8.0
    assert meta["final_loss"] == rec["losses"][-1]
    _assert_jax_loads_bit_for_bit(
        jrr.init_reranker_params(jrr.RerankerConfig.tiny(), 0), out)
    # served by both packages' CrossEncoderReranker with the cosine prior
    query = "What color is the beaker?"
    docs = _chunks(corpus)[:9]
    ref = jrr.CrossEncoderReranker(
        jrr.RerankerConfig.tiny(), checkpoint_path=str(out),
        embed_client=jec.make_embed_client("tpu", dim=512))
    got = trr.CrossEncoderReranker(
        trr.RerankerConfig.tiny(), checkpoint_path=str(out),
        embed_client=tec.make_embed_client("tpu", dim=512))
    assert got.cosine_lambda == ref.cosine_lambda == 8.0
    np.testing.assert_allclose(got.score(query, docs),
                               ref.score(query, docs), atol=F32_TOL, rtol=0)


# ----------------------------------------------------------- answer selector
def _qa_pairs(captions, seed=2, n_synth=10):
    rng = random.Random(seed)
    sents = jdata.sentences_of(captions) + [jdata.synth_sentence(rng)
                                            for _ in range(40)]
    return jdata.synthetic_answer_pairs(sents, rng, n_synth)


@pytest.mark.parametrize("k_cand", [4, 8, 64])
def test_selector_data_equals_the_jax_script(scripts, corpus, k_cand):
    jm = scripts["train_answer_selector"]
    tm = scripts["train_torch_answer_selector"]
    captions = tm.load_captions(str(corpus))
    assert captions == jm.load_captions(str(corpus))
    pairs = _qa_pairs(captions)
    for q, ctx in pairs:
        assert tm.truncated_candidates(q, ctx, k_cand, random.Random(4)) \
            == jm.truncated_candidates(q, ctx, k_cand, random.Random(4))
    jcfg = jrr.RerankerConfig.tiny()
    tcfg = trr.RerankerConfig.tiny()
    want = jm.build_examples(pairs, jcfg, k_cand, random.Random(7))
    got = tm.build_examples(pairs, tcfg, k_cand, random.Random(7))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for a, b in zip(g[:3], w[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert g[3:] == w[3:]
    for a, b in (("the red beaker", "a red beaker here"), ("", "x"),
                 ("a b a", "a a c")):
        assert tm.token_f1(a, b) == jm.token_f1(a, b)


def _selector_batch(k=8, t=40, seed=0):
    """Lists with K, 2 and 1 valid candidates; the invalid rows all
    pad (as ``build_examples`` pads them)."""
    rng = np.random.default_rng(seed)
    toks = np.full((3, k, t), jtok.PAD_ID, np.uint16)
    tgt = np.full((3, k), -1e30, np.float32)
    valid = np.zeros((3, k), bool)
    for i, nv in enumerate((k, 2, 1)):
        for j in range(nv):
            n = int(rng.integers(6, t))
            toks[i, j, :n] = rng.integers(0, 256, n)
        tgt[i, :nv] = rng.normal(0.0, 2.0, nv)
        valid[i, :nv] = True
    return toks, tgt, valid


def test_selector_loss_and_updates_match_the_jax_arithmetic(scripts):
    tm = scripts["train_torch_answer_selector"]
    jcfg, tcfg = jrr.RerankerConfig.tiny(), trr.RerankerConfig.tiny()
    toks, tgt, valid = _selector_batch()
    temp, lr, steps = 0.7, 3e-3, 20
    warmup = min(200, max(1, steps // 10))

    def loss_fn(p, toks, tgt, valid):        # train_answer_selector.py
        b, k, t = toks.shape
        logits = jrr.reranker_scores(p, jcfg, toks.astype(jnp.int32)
                                     .reshape(b * k, t)).reshape(b, k)
        logits = jnp.where(valid, logits, -1e30)
        nv = jnp.maximum(valid.sum(-1, keepdims=True), 1)
        vt = jnp.where(valid, tgt, 0.0)
        mean = vt.sum(-1, keepdims=True) / nv
        var = (jnp.where(valid, (vt - mean) ** 2, 0.0)
               .sum(-1, keepdims=True) / nv)
        z = (tgt - mean) * jax.lax.rsqrt(var + 1e-6)
        target = jax.nn.softmax(jnp.where(valid, z / temp, -1e30), axis=-1)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -(target * jnp.where(valid, logp, 0.0)).sum(-1).mean()

    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=warmup, decay_steps=max(steps, warmup + 1),
        end_value=lr * 0.05)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=0.01))
    jp = jrr.init_reranker_params(jcfg, 1)
    jo = tx.init(jp)
    tp = tcap.trainable(convert.reranker_params_from_jax(_numpy_tree(jp)))
    opt = ttrain.AdamW(tp, ttrain.warmup_cosine_decay_schedule(
        0.0, lr, warmup, max(steps, warmup + 1), lr * 0.05),
        weight_decay=0.01, max_norm=1.0)
    t_toks = torch.from_numpy(toks.astype(np.int16))
    # the listwise softmax does not see a shift of a list's scores, and
    # ln_f_bias and score_b shift every score of a list alike: their exact
    # gradient is zero, and AdamW scales the rounding noise in its place
    # to steps of about lr, which differ between the two packages
    shift = ("enc/ln_f_bias", "score_b")
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    for step in range(3):
        jloss, grads = grad_fn(
            jp, jnp.asarray(toks), jnp.asarray(tgt), jnp.asarray(valid))
        jgrads = _jax_leaves(grads)
        for key in shift:
            assert np.abs(jgrads[key]).max() < 1e-6, key
        updates, jo = tx.update(grads, jo, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        tloss = tm.selector_loss(tp, tcfg, t_toks, torch.from_numpy(tgt),
                                 torch.from_numpy(valid), temp)
        tloss.backward()
        assert np.isfinite(tloss.item()), step
        for key, leaf in tck.tree_leaves(tp):
            assert torch.isfinite(leaf.grad).all(), (step, key)
            np.testing.assert_allclose(
                _key_bias(key, leaf.grad.numpy()),
                _key_bias(key, jgrads[key]), atol=F32_TOL, rtol=0,
                err_msg=key)
        opt.update()
        assert abs(tloss.item() - float(jloss)) < F32_TOL, step
    _assert_trees_close(tp, jp, F32_TOL, skip=shift)
    # each list alone: 1, 2 and K valid candidates give finite losses
    # and gradients on their own too
    for i in range(3):
        opt.zero_grad()
        loss = tm.selector_loss(tp, tcfg, t_toks[i:i + 1],
                                torch.from_numpy(tgt[i:i + 1]),
                                torch.from_numpy(valid[i:i + 1]), temp)
        loss.backward()
        assert np.isfinite(loss.item())
        assert all(torch.isfinite(p.grad).all() for _, p in
                   tck.tree_leaves(tp) if p.grad is not None)


def test_selector_trainer_runs_caches_and_serves_in_both_packages(
        scripts, corpus, tmp_path, monkeypatch, capsys):
    tm = scripts["train_torch_answer_selector"]
    out = tmp_path / "answer_selector.npz"
    cache = tmp_path / "examples.npz"
    argv = ["--corpus", str(corpus), "--smoke", "--lr", "3e-3",
            "--device", "cpu", "--out", str(out), "--data-cache", str(cache)]
    built = tm.main(argv + ["--build-only"])
    assert cache.exists() and not out.exists() and built["examples"] > 4
    # the cache is the JAX script's format: an object array of examples
    with np.load(cache, allow_pickle=True) as z:
        examples = [tuple(e) for e in z["examples"]]
    assert len(examples) == built["examples"]
    assert examples[0][0].dtype == np.uint16 and examples[0][0].shape == (
        8, trr.RerankerConfig.tiny().max_len)
    rec = tm.main(argv)
    assert rec["device"] == "cpu" and len(rec["losses"]) == 8
    assert all(np.isfinite(rec["losses"])), rec["losses"]
    assert [s for s, _ in rec["held_losses"]] == [7]
    # the JAX script on the same cached examples: both draw the seed
    # weights from JAX's stream, so its logged losses (4 decimals) are the
    # port's (8 steps at this lr need not lower the loss: neither
    # package's does)
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [
        "train_answer_selector.py", "--corpus", str(corpus), "--smoke",
        "--lr", "3e-3", "--out", str(tmp_path / "jax_selector.npz"),
        "--data-cache", str(cache)])
    scripts["train_answer_selector"].main()
    logged = capsys.readouterr().out
    train = {int(m[1]): float(m[2]) for m in
             re.finditer(r"step\s+(\d+)\s+loss (\S+)", logged)}
    held = [float(m[1]) for m in re.finditer(r"HELD loss (\S+)", logged)]
    assert sorted(train) == [0, 7] and len(held) == 1, logged
    for step, want in train.items():
        assert abs(rec["losses"][step] - want) <= 5e-5 + F32_TOL, \
            (step, rec["losses"], logged)
    assert abs(rec["held_losses"][0][1] - held[0]) <= 5e-5 + F32_TOL
    meta = json.loads(out.with_suffix(".json").read_text())
    assert set(meta) == {"selector_cfg", "steps", "train_examples"}
    assert meta["selector_cfg"] == {"width": 32, "layers": 2, "heads": 2,
                                    "max_len": 96, "query_budget": 24}
    _assert_jax_loads_bit_for_bit(
        jrr.init_reranker_params(jrr.RerankerConfig.tiny(), 0), out)
    # both packages' AnswerSelector read the sidecar's architecture
    ref = jsel.AnswerSelector(checkpoint_path=str(out))
    got = tsel.AnswerSelector(checkpoint_path=str(out))
    assert got.cfg.width == ref.cfg.width == 32
    for _toks, _tgt, _valid, q, ctx, _ans in examples[:4]:
        cand = tm.truncated_candidates(q, ctx, 8, random.Random(0))
        if cand is None:
            continue
        np.testing.assert_allclose(got.score(q, cand[0]),
                                   ref.score(q, cand[0]), atol=F32_TOL,
                                   rtol=0)
        assert got.answer(q, ctx) == ref.answer(q, ctx)


def test_selector_trainer_saves_the_running_best(scripts, corpus, tmp_path):
    """Past 1000 steps the held-out loss is read every 1000 steps and the
    running best is written with ``"partial": true`` before the end."""
    tm = scripts["train_torch_answer_selector"]
    out = tmp_path / "sel.npz"
    seen = []
    real_save = tm.save_params

    def save(params, path):
        seen.append(json.loads(Path(path).with_suffix(".json").read_text())
                    if Path(path).with_suffix(".json").exists() else None)
        return real_save(params, path)

    tm.save_params = save
    try:
        rec = tm.main(["--corpus", str(corpus), "--smoke", "--device",
                       "cpu", "--out", str(out)])
    finally:
        tm.save_params = real_save
    # the smoke's 8 steps read it once, at the last step: one partial save
    # and the final save, whose sidecar replaces the partial one
    assert [s for s, _ in rec["held_losses"]] == [7]
    assert len(seen) == 2 and seen[1]["partial"] is True
    assert seen[1]["held_best_step"] == 7
    assert "partial" not in json.loads(out.with_suffix(".json").read_text())


# ------------------------------------------------------------ text embedder
def test_embedder_data_equals_the_jax_script(scripts, corpus, tmp_path):
    jm = scripts["train_text_embedder"]
    tm = scripts["train_torch_text_embedder"]
    sents = tm.load_sentences(str(corpus))
    assert sents == jm.load_sentences(str(corpus)) and len(sents) > 100
    txt = tmp_path / "lines.txt"
    txt.write_text("\n".join(_chunks(corpus)[:6]) + "\nshort\n")
    assert tm.load_sentences(str(txt)) == jm.load_sentences(str(txt))
    ga, gb = np.random.default_rng(9), np.random.default_rng(9)
    for s in sents + ["a b c d e", "the of and", "one two three four x"]:
        assert tm.augment(s, ga) == jm.augment(s, gb)
    assert ga.integers(1 << 30) == gb.integers(1 << 30)
    # the hash teacher's recall@1, on the JAX script's protocol
    erng = np.random.default_rng(123)
    teacher = jte.HashedNGramEmbedder(dim=64)
    hq = teacher.embed([jm.augment(s, erng) for s in sents[:20]])
    hd = teacher.embed(sents[:20])
    want = float(((hq @ hd.T).argmax(1) == np.arange(20)).mean())
    assert tm.hash_recall(tte.HashedNGramEmbedder(dim=64), sents[:20]) \
        == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedder_loss_and_updates_match_the_jax_arithmetic(scripts, corpus,
                                                            dtype):
    tm = scripts["train_torch_text_embedder"]
    width, layers, heads, dim, max_len, qlen = 32, 2, 2, 48, 384, 96
    tau, distill, lr, steps = 0.05, 4.0, 3e-3, 10
    jcfg = jcap.CaptionerConfig(width=width, layers=layers, heads=heads,
                                vision_dim=width, num_vision_tokens=1,
                                max_len=max_len + 1,
                                dtype=getattr(jnp, dtype))
    tcfg = tm.encoder_config(width, layers, heads, max_len,
                             getattr(torch, dtype))
    sents = tm.load_sentences(str(corpus))[:12]
    queries = [tm.augment(s, np.random.default_rng(1)) for s in sents]
    tok_q = jtok.batch_encode(queries, qlen)
    tok_d = jtok.batch_encode(sents, max_len)
    t_emb = jte.HashedNGramEmbedder(dim=dim).embed(sents)
    t_sim = t_emb @ t_emb.T
    np.testing.assert_allclose(
        tte.HashedNGramEmbedder(dim=dim).embed(sents), t_emb, atol=1e-6)

    def loss_fn(p, tok_q, tok_d, t_sim, cfg=jcfg):  # train_text_embedder.py
        zq = jte.encoder_forward(p, cfg, tok_q)
        zd = jte.encoder_forward(p, cfg, tok_d)
        sim = (zq @ zd.T) / tau
        targets = jnp.arange(zq.shape[0])
        nce = (optax.softmax_cross_entropy_with_integer_labels(
                   sim, targets).mean()
               + optax.softmax_cross_entropy_with_integer_labels(
                   sim.T, targets).mean()) / 2.0
        dist = jnp.mean((zd @ zd.T - t_sim) ** 2)
        return nce + distill * dist, (nce, dist)

    opt_j = optax.adamw(optax.cosine_decay_schedule(lr, steps, 0.1),
                        weight_decay=1e-4)
    jp = jte.init_encoder_params(jcfg, dim, 4)
    jo = opt_j.init(jp)
    tp = tcap.trainable(convert.encoder_params_from_jax(_numpy_tree(jp)))
    opt = ttrain.AdamW(tp, ttrain.cosine_decay_schedule(lr, steps, 0.1),
                       weight_decay=1e-4)
    assert opt.max_norm is None
    loss_tol = F32_TOL if dtype == "float32" else BF16_LOSS_TOL
    tq = tm.tokens(queries, qlen, torch.device("cpu"))
    td = tm.tokens(sents, max_len, torch.device("cpu"))
    assert td.shape[1] < max_len, "the batch has pad columns to drop"
    batch = (jnp.asarray(tok_q), jnp.asarray(tok_d), jnp.asarray(t_sim))
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    if dtype == "bfloat16":       # the exact gradient of the first step
        exact = _jax_leaves(jax.grad(lambda p: loss_fn(
            p, *batch, cfg=dataclasses.replace(jcfg, dtype=jnp.float32))[0]
        )(jp))
    for step in range(2):
        (jloss, (jnce, jdist)), grads = grad_fn(jp, *batch)
        updates, jo = opt_j.update(grads, jo, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        loss, (nce, dist) = tm.embedder_loss(
            tp, tcfg, tq, td, torch.from_numpy(t_sim), tau, distill)
        loss.backward()
        if step == 0 and dtype == "bfloat16":
            for key, leaf in tck.tree_leaves(tp):
                got = _key_bias(key, leaf.grad.numpy())
                want = _key_bias(key, exact[key])
                rel = np.linalg.norm(got - want) / np.linalg.norm(want)
                assert rel <= BF16_GRAD_TOL, (key, rel)
        opt.update()
        assert abs(loss.item() - float(jloss)) < loss_tol, \
            (step, loss.item(), float(jloss))
        assert abs(nce.item() - float(jnce)) < loss_tol
        assert abs(dist.item() - float(jdist)) < loss_tol
    if dtype == "float32":
        _assert_trees_close(tp, jp, F32_TOL)


def test_embedder_trainer_runs_and_serves_in_both_packages(scripts, corpus,
                                                           tmp_path):
    tm = scripts["train_torch_text_embedder"]
    out = tmp_path / "text_embedder.npz"
    rec = tm.main(["--corpus", str(corpus), "--steps", "24", "--batch",
                   "16", "--width", "32", "--layers", "2", "--heads", "2",
                   "--dim", "48", "--max-len", "128", "--query-len", "48",
                   "--lr", "3e-3", "--device", "cpu", "--out", str(out)])
    assert rec["device"] == "cpu" and len(rec["losses"]) == 24
    assert all(np.isfinite(rec["losses"])) and _falls(rec["losses"]), \
        rec["losses"]
    assert [s for s, _ in rec["recalls"]] == [0, 23]
    meta = json.loads(out.with_suffix(".json").read_text())
    assert set(meta) == {"width", "layers", "heads", "dim", "max_len",
                         "eval_recall_at_1", "hash_recall_at_1", "steps",
                         "corpus"}
    assert (meta["width"], meta["dim"], meta["max_len"]) == (32, 48, 128)
    jcfg = jcap.CaptionerConfig(width=32, layers=2, heads=2, vision_dim=32,
                                num_vision_tokens=1, max_len=129)
    _assert_jax_loads_bit_for_bit(jte.init_encoder_params(jcfg, 48, 0), out)
    texts = _chunks(corpus)[:6] + ["What color is the beaker?"]
    kw = dict(dim=48, width=32, layers=2, heads=2, max_len=128,
              checkpoint_path=str(out))
    ref = jte.TransformerTextEmbedder(dtype=jnp.float32, **kw).embed(texts)
    got = tte.TransformerTextEmbedder(dtype=torch.float32, **kw).embed(texts)
    np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=0)
    # the sidecar carries the widths: both packages' clients (bf16) take
    # the checkpoint from its path alone
    ref_c = jec.make_embed_client("transformer", checkpoint_path=str(out))
    got_c = tec.make_embed_client("transformer", checkpoint_path=str(out))
    assert got_c.dim == ref_c.dim == 48
    np.testing.assert_allclose(got_c.embed(texts), ref_c.embed(texts),
                               atol=3e-3, rtol=0)


@pytest.mark.parametrize("name", ["train_torch_reranker",
                                  "train_torch_answer_selector",
                                  "train_torch_text_embedder"])
def test_the_default_device_is_cuda_and_its_absence_raises(scripts, name,
                                                           corpus, tmp_path,
                                                           monkeypatch):
    """Without ``--device cpu`` a host with no card raises before any
    work (``--tiny`` and ``--smoke`` do not choose the device)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("VIDGRAPH_TORCH_DEVICE", "cpu")
    argv = ["--corpus", str(corpus), "--out", str(tmp_path / "x.npz")]
    argv += {"train_torch_reranker": ["--tiny"],
             "train_torch_answer_selector": ["--smoke"]}.get(name, [])
    with pytest.raises(RuntimeError, match="cuda"):
        scripts[name].main(argv)
    assert not (tmp_path / "x.npz").exists()
