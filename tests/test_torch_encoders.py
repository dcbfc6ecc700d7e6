"""The port's trained encoders against the JAX package's.

Weights are drawn by the JAX package (``init_encoder_params``,
``init_reranker_params``), saved as its npz, and read by the port through
``models/checkpoint.py::load_params`` (``checkpoint_path``) or handed over
with ``convert.encoder_params_from_jax`` / ``reranker_params_from_jax``.
Same texts, same weights:

* float32 configs: embeddings and scores within 1e-5 (``F32_TOL``);
* the bfloat16 text embedder (the default): within ``BF16_TOL`` (3e-3) a
  component of the unit vectors (the difference at the default widths is
  6.4e-4), and cosine orderings equal wherever the neighbouring cosines
  are more than twice that apart;
* client orderings, selector answers and chat-client answers equal.
"""
import asyncio
import json
import os

os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.models import answer_selector as jsel  # noqa: E402
from vidgraph_tpu.models import checkpoint as jck  # noqa: E402
from vidgraph_tpu.models import reranker as jrr  # noqa: E402
from vidgraph_tpu.models import text_embedder as jte  # noqa: E402
from vidgraph_tpu.models.captioner import \
    CaptionerConfig as JCaptionerConfig  # noqa: E402
from vidgraph_tpu.services import llm_client as jllm  # noqa: E402
from vidgraph_tpu.services import rerank_client as jrc  # noqa: E402
from vidgraph_tpu_torch import convert  # noqa: E402
from vidgraph_tpu_torch.models import answer_selector as tsel  # noqa: E402
from vidgraph_tpu_torch.models import captioner as tcap  # noqa: E402
from vidgraph_tpu_torch.models import reranker as trr  # noqa: E402
from vidgraph_tpu_torch.models import text_embedder as tte  # noqa: E402
from vidgraph_tpu_torch.services import embed_client as tec  # noqa: E402
from vidgraph_tpu_torch.services import llm_client as tllm  # noqa: E402
from vidgraph_tpu_torch.services import rerank_client as trc  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 3e-3

TEXTS = [
    "The person holds a red beaker on the laboratory bench.",
    "A blue flask sits nearby",
    "Time: 00:05 Content: gloves, goggles and a -56.301 g reading",
    "",
    "a",
    "Ünïcödé — 温度计 and a thermometer",
    "the scientist pours liquid into the red beaker",
    "a balance displays 42.5 g " * 12,
    "gloves on the bench",
    "The person holds a red beaker on the laboratory bench.",
]
QUERY = "who holds the red beaker?"
CTX = """Found results for 'what color is the beaker?':
Chunks (3):
  1. Time: 00:10-00:15
Content: The scientist pours liquid into a red beaker. (score: 0.83)
  2. The balance displays a reading of 42.5 g. (score: 0.76)
  3. A person in gloves walks to the bench. The beaker is on the balance.
"""
QUESTIONS = ["what color is the beaker?", "what does the balance display?",
             "who walks to the bench?", "where is the beaker?"]


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree)


def _encoder_npz(tmp_path, dim, width, layers, heads, max_len, seed=3):
    cfg = JCaptionerConfig(width=width, layers=layers, heads=heads,
                           vision_dim=width, num_vision_tokens=1,
                           max_len=max_len + 1, dtype=jnp.float32)
    params = jte.init_encoder_params(cfg, dim, seed)
    path = tmp_path / "enc.npz"
    jck.save_params(params, str(path))
    return str(path), params


def _reranker_npz(tmp_path, cfg, seed=5, name="rr.npz", sidecar=None):
    params = jrr.init_reranker_params(cfg, seed)
    path = tmp_path / name
    jck.save_params(params, str(path))
    if sidecar is not None:
        path.with_suffix(".json").write_text(json.dumps(sidecar))
    return str(path), params


def _selector_sidecar(cfg):
    return {"selector_cfg": {"width": cfg.width, "layers": cfg.layers,
                             "heads": cfg.heads, "max_len": cfg.max_len,
                             "query_budget": cfg.query_budget}}


def _order_equal_where_decided(got, ref, tol):
    """Ranks of ``ref``'s order agree with ``got``'s wherever the
    neighbouring ``ref`` scores are more than ``tol`` apart."""
    order = np.argsort(-ref, kind="stable")
    s = ref[order]
    padded = np.concatenate([[np.inf], s, [-np.inf]])
    got_order = np.argsort(-got, kind="stable")
    for j in range(len(s)):
        if padded[j] - padded[j + 1] > tol and \
                padded[j + 1] - padded[j + 2] > tol:
            assert got_order[j] == order[j], (j, got, ref)


# ------------------------------------------------------------ text embedder
@pytest.mark.parametrize("shape", [(64, 32, 2, 2, 32), (48, 64, 3, 4, 96)])
def test_transformer_embedder_f32_equals_jax(tmp_path, shape):
    dim, width, layers, heads, max_len = shape
    path, _ = _encoder_npz(tmp_path, *shape)
    kw = dict(dim=dim, width=width, layers=layers, heads=heads,
              max_len=max_len, checkpoint_path=path)
    ref = jte.TransformerTextEmbedder(dtype=jnp.float32, **kw).embed(TEXTS)
    got = tte.TransformerTextEmbedder(dtype=torch.float32, **kw).embed(TEXTS)
    assert got.shape == ref.shape == (len(TEXTS), dim)
    np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_encoder_forward_through_convert_equals_jax(tmp_path):
    """``encoder_forward`` on the JAX tree handed over by
    ``convert.encoder_params_from_jax``, on the same padded tokens."""
    from vidgraph_tpu.models import tokenizer

    shape = (40, 32, 2, 4, 48)
    _, params = _encoder_npz(tmp_path, *shape)
    cfg_j = JCaptionerConfig(width=32, layers=2, heads=4, vision_dim=32,
                             num_vision_tokens=1, max_len=49,
                             dtype=jnp.float32)
    cfg_t = tcap.CaptionerConfig(width=32, layers=2, heads=4, vision_dim=32,
                                 num_vision_tokens=1, max_len=49,
                                 dtype=torch.float32)
    toks = tokenizer.batch_encode(TEXTS, 48)
    ref = np.asarray(jte.encoder_forward(params, cfg_j, jnp.asarray(toks)))
    tparams = convert.encoder_params_from_jax(_numpy_tree(params))
    got = tte.encoder_forward(tparams, cfg_t,
                              torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=0)
    # rows are independent: one row alone gives the batch's row
    one = tte.encoder_forward(tparams, cfg_t,
                              torch.from_numpy(toks[2:3]).long()).numpy()
    np.testing.assert_allclose(one[0], got[2], atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        convert.encoder_params_from_jax({"enc": {}})


def test_transformer_embedder_bf16_default_within_tolerance(tmp_path):
    """The shipped default (dim 512, width 256, 4 layers, 4 heads,
    max_len 128, bfloat16 compute) on JAX-drawn float32 weights."""
    path, _ = _encoder_npz(tmp_path, 512, 256, 4, 4, 128)
    ref_emb = jte.TransformerTextEmbedder(checkpoint_path=path)
    emb = tte.TransformerTextEmbedder(checkpoint_path=path)
    assert emb._cfg.dtype == torch.bfloat16
    ref, got = ref_emb.embed(TEXTS), emb.embed(TEXTS)
    err = float(np.abs(got - ref).max())
    assert err <= BF16_TOL, err
    q_ref, q_got = ref_emb.embed_query(QUERY), emb.embed_query(QUERY)
    _order_equal_where_decided(got @ q_got, ref @ q_ref, 2 * BF16_TOL)
    # the cache serves repeats without a second forward
    assert np.array_equal(emb.embed(TEXTS[:1]), got[:1])


def test_hybrid_embedder_doubles_dim_and_equals_jax(tmp_path):
    shape = (64, 32, 2, 2, 64)
    path, _ = _encoder_npz(tmp_path, *shape)
    (tmp_path / "enc.json").write_text(json.dumps(
        {"dim": 64, "width": 32, "layers": 2, "heads": 2, "max_len": 64}))
    from vidgraph_tpu.services.embed_client import \
        make_embed_client as jax_client

    ref_c = jax_client("hybrid", dim=512, checkpoint_path=path)
    got_c = tec.make_embed_client("hybrid", dim=512, checkpoint_path=path)
    assert got_c.dim == ref_c.dim == 128
    # bfloat16 transformer channel, weighted by sqrt(0.15)
    err = float(np.abs(got_c.embed(TEXTS) - ref_c.embed(TEXTS)).max())
    assert err <= BF16_TOL, err
    h = tte.make_embedder("hybrid", dim=64, width=32, layers=2, heads=2,
                          max_len=64, checkpoint_path=path)
    assert h.dim == 128 and h.embed([]).shape == (0, 128)
    t = tec.make_embed_client("transformer", dim=512, checkpoint_path=path)
    assert t.dim == 64
    with pytest.raises(ValueError):
        tte.make_embedder("nope")


# ---------------------------------------------------------------- reranker
@pytest.mark.parametrize("cfg_name", ["tiny", "default"])
def test_reranker_scores_f32_equal_jax(tmp_path, cfg_name):
    jcfg = getattr(jrr.RerankerConfig, cfg_name)() if cfg_name == "tiny" \
        else jrr.RerankerConfig()
    tcfg = getattr(trr.RerankerConfig, cfg_name)() if cfg_name == "tiny" \
        else trr.RerankerConfig()
    assert (tcfg.width, tcfg.layers, tcfg.heads, tcfg.max_len,
            tcfg.query_budget) == (jcfg.width, jcfg.layers, jcfg.heads,
                                   jcfg.max_len, jcfg.query_budget)
    _, params = _reranker_npz(tmp_path, jcfg)
    docs = TEXTS[:5] if cfg_name == "default" else TEXTS
    toks = jrr.batch_encode_pairs(QUERY, docs, jcfg)
    assert np.array_equal(toks, trr.batch_encode_pairs(QUERY, docs, tcfg))
    assert jrr.encode_pair(QUERY * 20, "d" * 900, jcfg) == \
        trr.encode_pair(QUERY * 20, "d" * 900, tcfg)
    ref = np.asarray(jrr.reranker_scores(params, jcfg, jnp.asarray(toks)))
    tparams = convert.reranker_params_from_jax(_numpy_tree(params))
    got = trr.reranker_scores(tparams, tcfg,
                              torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=0)
    with pytest.raises(ValueError):
        convert.reranker_params_from_jax({"enc": {}, "out_w": 0})


@pytest.mark.parametrize("cosine_lambda", [None, 0.0, 2.5])
def test_cross_encoder_score_equals_jax(tmp_path, cosine_lambda):
    """``CrossEncoderReranker.score`` from the npz, without a sidecar, and
    with a ``cosine_lambda`` sidecar whose prior rides on the embed
    client (the same hash embedder in both packages)."""
    from vidgraph_tpu.services.embed_client import \
        make_embed_client as jax_client

    cfg_j, cfg_t = jrr.RerankerConfig.tiny(), trr.RerankerConfig.tiny()
    sidecar = (None if cosine_lambda is None
               else {"cosine_lambda": cosine_lambda})
    path, _ = _reranker_npz(tmp_path, cfg_j, sidecar=sidecar)
    ref_m = jrr.CrossEncoderReranker(cfg_j, checkpoint_path=path,
                                     embed_client=jax_client("tpu", dim=64))
    got_m = trr.CrossEncoderReranker(
        cfg_t, checkpoint_path=path,
        embed_client=tec.make_embed_client("tpu", dim=64))
    assert got_m.cosine_lambda == ref_m.cosine_lambda == (cosine_lambda or 0)
    ref, got = ref_m.score(QUERY, TEXTS), got_m.score(QUERY, TEXTS)
    np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=0)
    _order_equal_where_decided(got, ref, 2 * F32_TOL)
    assert got_m.score(QUERY, []).shape == (0,)


def test_trained_rerank_client_equals_jax(tmp_path):
    cfg = jrr.RerankerConfig()
    path, _ = _reranker_npz(tmp_path, cfg, sidecar={"cosine_lambda": 1.5})
    from vidgraph_tpu.services.embed_client import \
        make_embed_client as jax_client

    ref_c = jrc.make_rerank_client("trained", jax_client("tpu", dim=512),
                                   checkpoint_path=path)
    got_c = trc.make_rerank_client("trained",
                                   tec.make_embed_client("tpu", dim=512),
                                   checkpoint_path=path)
    assert isinstance(got_c, trc.TrainedRerankClient)
    docs = TEXTS[:8]
    ref = asyncio.run(ref_c.rerank(QUERY, docs, 5))
    got = asyncio.run(got_c.rerank(QUERY, docs, 5))
    assert [i for i, _ in got] == [i for i, _ in ref]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in ref],
                               atol=F32_TOL, rtol=0)
    assert asyncio.run(got_c.rerank(QUERY, [], 5)) == []


# ---------------------------------------------------------- answer selector
@pytest.mark.parametrize("mode", ["blend", "pure"])
def test_answer_selector_equals_jax(tmp_path, mode):
    """Both modes on the same npz: scores within 1e-5, answers equal; the
    ``selector_cfg`` sidecar restores the architecture in both."""
    cfg = jrr.RerankerConfig.tiny()
    path, params = _reranker_npz(tmp_path, cfg, seed=2,
                                 sidecar=_selector_sidecar(cfg))
    ref_s = jsel.AnswerSelector(checkpoint_path=path, mode=mode)
    got_s = tsel.AnswerSelector(checkpoint_path=path, mode=mode)
    assert got_s.cfg.max_len == ref_s.cfg.max_len == cfg.max_len
    assert torch.equal(got_s.params["score_w"],
                       torch.from_numpy(np.asarray(params["score_w"])))
    cands = ["The red beaker.", "A balance.", "The bench.", "gloves"]
    np.testing.assert_allclose(got_s.score(QUESTIONS[0], cands),
                               ref_s.score(QUESTIONS[0], cands),
                               atol=F32_TOL, rtol=0)
    for q in QUESTIONS:
        assert got_s.answer(q, CTX) == ref_s.answer(q, CTX), q
    assert got_s.answer("anything", "No results found") == "I don't know."


def test_local_chat_client_with_a_present_selector_answers_as_jax(tmp_path):
    from vidgraph_tpu.pipeline.prompts import build_benchmark_answer_prompt

    cfg = jrr.RerankerConfig.tiny()
    path, _ = _reranker_npz(tmp_path, cfg, sidecar=_selector_sidecar(cfg))
    ref_c = jllm.make_chat_client("local", answer_selector_path=path)
    got_c = tllm.make_chat_client("local", answer_selector_path=path)
    assert isinstance(got_c._selector, tsel.AnswerSelector)
    for q in QUESTIONS:
        prompt = build_benchmark_answer_prompt(q, CTX)
        assert got_c.complete_sync(prompt) == ref_c.complete_sync(prompt)


def test_trimmed_padding_gives_the_padded_scores():
    """The port leaves out trailing all-pad columns; the scores and
    embeddings are those of the fully padded rows (JAX's shapes)."""
    cfg = trr.RerankerConfig.tiny()
    params = trr.init_reranker_params(cfg, seed=1)
    toks = trr.batch_encode_pairs(QUERY, TEXTS[:6], cfg)
    assert tte.trim_padding(toks).shape[1] < toks.shape[1] == cfg.max_len
    full = trr.reranker_scores(params, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(
        trr.score_tokens(params, cfg, toks, torch.device("cpu")),
        full.numpy(), atol=1e-6, rtol=0)
    pad = np.full((2, 5), 256, np.int32)
    assert tte.trim_padding(pad).shape == (2, 1)
