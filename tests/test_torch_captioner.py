"""The port's captioner (chat LM) against the JAX package's, on the CPU.

Weights are the JAX package's ``init_params``, carried across with
``convert.captioner_params_from_jax``; inputs are made from a numpy seed.

Tolerances:
* f32 ``tiny`` logits within 1e-5 (the same float32 arithmetic in another
  summation order);
* the bf16 2-layer config at width 512 within 2e-2 absolute on logits of
  about unit scale: both packages round every product and bias add to
  bfloat16 (about 3 significant digits), at places that differ by a few
  units in the last place;
* greedy tokens equal on f32 configs (the JAX tests' own standard).

On the CPU the JAX package's ``flash=True`` falls back to the einsum path
(``tests/test_flash_attention.py``), and the port's to the plain version
(``tests/test_torch_flash_attention.py`` holds that to the JAX masks).
"""
import os

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.models import captioner as jcap  # noqa: E402
from vidgraph_tpu.models import tokenizer  # noqa: E402
from vidgraph_tpu.models.grammar import pipeline_grammar  # noqa: E402
from vidgraph_tpu_torch.convert import captioner_params_from_jax  # noqa: E402
from vidgraph_tpu_torch.models import captioner as tcap  # noqa: E402

J_TINY = jcap.CaptionerConfig.tiny()
T_TINY = tcap.CaptionerConfig.tiny()


def _port_cfg(jcfg):
    dtype = {jnp.float32: torch.float32,
             jnp.bfloat16: torch.bfloat16}[jcfg.dtype]
    return tcap.CaptionerConfig(
        width=jcfg.width, layers=jcfg.layers, heads=jcfg.heads,
        vocab=jcfg.vocab, vision_dim=jcfg.vision_dim,
        num_vision_tokens=jcfg.num_vision_tokens, max_len=jcfg.max_len,
        dtype=dtype)


def _both(jcfg, seed, param_dtype=jnp.float32):
    jp = jcap.init_params(jcfg, seed=seed, param_dtype=param_dtype)
    tp = captioner_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jp, tp


def test_configs_and_param_tree_match():
    assert T_TINY == _port_cfg(J_TINY)
    chat = tcap.CaptionerConfig.chat()
    assert (chat.width, chat.layers, chat.heads, chat.max_len,
            chat.num_vision_tokens) == (512, 8, 8, 4096, 8)
    assert chat.dtype == torch.bfloat16
    assert chat.num_params == jcap.CaptionerConfig.chat().num_params
    jp = jcap.init_params(J_TINY, seed=0)
    tp = tcap.init_params(T_TINY, 0)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    from vidgraph_tpu_torch.models.checkpoint import tree_leaves
    tl = dict(tree_leaves(tp))
    assert len(jl) == len(tl)
    assert sum(t.numel() for t in tl.values()) == T_TINY.num_params
    for path, leaf in jl:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        assert tuple(tl[key].shape) == leaf.shape, key
        assert tl[key].dtype == torch.float32


def _inputs(jcfg, b, t, seed):
    rng = np.random.default_rng(seed)
    vis = rng.normal(size=(b, jcfg.num_vision_tokens,
                           jcfg.vision_dim)).astype(np.float32)
    toks = rng.integers(0, 256, (b, t)).astype(np.int32)
    return vis, toks


@pytest.mark.parametrize("flash", [False, True])
def test_forward_tiny_f32_within_1e5(flash):
    jp, tp = _both(J_TINY, seed=3)
    vis, toks = _inputs(J_TINY, 2, 19, 0)
    ref = np.asarray(jcap.forward(jp, J_TINY, jnp.asarray(vis),
                                  jnp.asarray(toks), flash=flash))
    got = tcap.forward(tp, T_TINY, torch.from_numpy(vis),
                       torch.from_numpy(toks).long(), flash=flash)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("param_dtype", [jnp.float32, jnp.bfloat16])
def test_forward_bf16_width512_two_layers(param_dtype):
    jcfg = jcap.CaptionerConfig(layers=2, max_len=128)
    jp, tp = _both(jcfg, seed=4, param_dtype=param_dtype)
    vis, toks = _inputs(jcfg, 2, 40, 1)
    ref = np.asarray(jcap.forward(jp, jcfg, jnp.asarray(vis),
                                  jnp.asarray(toks)))
    got = tcap.forward(tp, _port_cfg(jcfg), torch.from_numpy(vis),
                       torch.from_numpy(toks).long()).numpy()
    assert np.abs(ref).max() > 0.3            # logits of about unit scale
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=0)


# ---------------------------------------------------------------------------
# generate_from_tokens, mirroring tests/test_generate_from_tokens.py
# ---------------------------------------------------------------------------

def _batch(prompts, t_pad):
    ids_list = [tokenizer.encode(p, add_bos=True, add_eos=False)
                for p in prompts]
    toks = np.full((len(prompts), t_pad), tokenizer.PAD_ID, np.int32)
    lens = np.zeros((len(prompts),), np.int32)
    for r, ids in enumerate(ids_list):
        toks[r, :len(ids)] = ids
        lens[r] = len(ids)
    return toks, lens


def _generate_both(jp, tp, jcfg, toks, lens, max_new, starts=None):
    gj, gt = {}, {}
    if starts is not None:
        g = pipeline_grammar()
        gj = {"grammar_trans": g.device_table(),
              "grammar_start": jnp.asarray(starts)}
        gt = {"grammar_trans": torch.from_numpy(g.trans),
              "grammar_start": torch.from_numpy(starts)}
    ref = np.asarray(jcap.generate_from_tokens(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(lens), max_new=max_new,
        **gj))
    got = tcap.generate_from_tokens(
        tp, _port_cfg(jcfg), torch.from_numpy(toks), torch.from_numpy(lens),
        max_new=max_new, **gt).numpy()
    return got, ref


@pytest.mark.parametrize("t_pad", [16, 24, 32])
def test_generate_ragged_rows_equal_jax(t_pad):
    jp, tp = _both(J_TINY, seed=3)
    prompts = ["red beaker", "a", "blue flame on", "acid"]
    toks, lens = _batch(prompts, t_pad)
    got, ref = _generate_both(jp, tp, J_TINY, toks, lens, max_new=8)
    assert got.dtype == np.int32 and got.shape == (4, 8)
    np.testing.assert_array_equal(got, ref)


def test_generate_filler_rows_emit_eos():
    jp, tp = _both(J_TINY, seed=1)
    toks, lens = _batch(["abc", "hello", "", ""], 16)
    lens[2:] = 0                                   # inert filler rows
    got, ref = _generate_both(jp, tp, J_TINY, toks, lens, max_new=6)
    np.testing.assert_array_equal(got, ref)
    assert (got[2:] == tokenizer.EOS_ID).all()


def test_generate_with_grammar_equals_jax():
    from vidgraph_tpu.models.grammar import FREE
    g = pipeline_grammar()
    jcfg = jcap.CaptionerConfig(width=32, layers=2, heads=2, vision_dim=32,
                                num_vision_tokens=2, max_len=160,
                                dtype=jnp.float32)
    jp, tp = _both(jcfg, seed=7)
    prompts = ["TRIPLET LINES: a person holds", '{"is_correct": x',
               'return {"triplets": []}', "free text", "pad"]
    toks, lens = _batch(prompts, 32)
    lens[4] = 0
    starts = np.array([g.starts["pre"], g.starts["judge"],
                       g.starts["consolidate"], FREE, FREE], np.int32)
    got, ref = _generate_both(jp, tp, jcfg, toks, lens, max_new=64,
                              starts=starts)
    np.testing.assert_array_equal(got, ref)
    judge = tokenizer.decode(got[1])
    assert judge.startswith('{"is_correct": ')


def test_generate_matches_teacher_forcing():
    jp, tp = _both(J_TINY, seed=0)
    ids = tokenizer.encode("hello wor", add_bos=True, add_eos=False)
    toks, lens = _batch(["hello wor"], 16)
    out = tcap.generate_from_tokens(tp, T_TINY, torch.from_numpy(toks),
                                    int(lens[0]), max_new=4)[0]
    cur = list(ids)
    vis = torch.zeros((1, T_TINY.num_vision_tokens, T_TINY.vision_dim))
    for i in range(4):
        logits = tcap.forward(tp, T_TINY, vis, torch.tensor([cur]))
        nxt = int(logits[0, -1].argmax())
        assert int(out[i]) == nxt, f"step {i}"
        cur.append(nxt)


def test_context_overflow_raises():
    tp = tcap.init_params(T_TINY)
    with pytest.raises(ValueError, match="max_len"):
        tcap.generate_from_tokens(tp, T_TINY,
                                  torch.full((1, 64), 1, dtype=torch.int32),
                                  3, max_new=32)


def _eos_spike(params, spike_pos):
    """Plant a huge pos_emb component along the EOS head column from
    ``spike_pos`` on, so the argmax flips to EOS there (as
    ``tests/test_generate_from_tokens.py`` does)."""
    v = np.asarray(params["head_w"][:, tokenizer.EOS_ID], np.float32)
    pe = np.array(params["pos_emb"], np.float32)
    pe[spike_pos:] = v * (1000.0 / max(np.linalg.norm(v), 1e-6))
    return pe


def test_early_stop_is_token_identical_to_the_static_scan(monkeypatch):
    """The port's loop stops once every row is done; the JAX package runs
    a static scan whose done rows emit EOS.  With EOS planted 3 steps in,
    the tokens are equal at budgets 8 and 64, and the port runs far fewer
    than 64 steps."""
    jcfg = jcap.CaptionerConfig(width=32, layers=2, heads=2, vision_dim=32,
                                num_vision_tokens=2, max_len=128,
                                dtype=jnp.float32)
    jp, tp = _both(jcfg, seed=5)
    ids = tokenizer.encode("green", add_bos=True, add_eos=False)
    pe = _eos_spike(jp, jcfg.num_vision_tokens + len(ids) + 3)
    jp["pos_emb"] = jnp.asarray(pe)
    tp["pos_emb"] = torch.from_numpy(pe)
    toks, lens = _batch(["green"], 16)
    steps = []
    real = tcap._step_block

    def counting(*a, **kw):
        steps.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(tcap, "_step_block", counting)
    for max_new in (8, 64):
        steps.clear()
        got, ref = _generate_both(jp, tp, jcfg, toks, lens, max_new)
        np.testing.assert_array_equal(got, ref)
        eos_at = np.where(got[0] == tokenizer.EOS_ID)[0]
        assert eos_at.size and 0 < eos_at[0] < 8
    assert len(steps) // jcfg.layers < 64 - 1
