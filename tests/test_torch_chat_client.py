"""The port's on-device chat client (``backend.llm: tpu``) against the JAX
package's, on the CPU, with the same small-config weights in both: batch
and coalesced completions give equal texts, and the KG build of the
golden vlm output through either client gives equal graphs.  Mirrors the
client tests of ``tests/test_generate_from_tokens.py``.

Standard: texts equal exactly (f32 small configs, greedy decode; the JAX
tests' own standard for their client).
"""
import asyncio
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import vidgraph_tpu.core.config as jcfg_mod  # noqa: E402
import vidgraph_tpu.graph as jgraph  # noqa: E402
import vidgraph_tpu.pipeline.kg_builder as jkg  # noqa: E402
import vidgraph_tpu_torch.core.config as tcfg_mod  # noqa: E402
import vidgraph_tpu_torch.graph as tgraph  # noqa: E402
import vidgraph_tpu_torch.pipeline.kg_builder as tkg  # noqa: E402
from vidgraph_tpu.models import captioner as jcap  # noqa: E402
from vidgraph_tpu.services import llm_client as jllm  # noqa: E402
from vidgraph_tpu_torch.convert import captioner_params_from_jax  # noqa: E402
from vidgraph_tpu_torch.models import captioner as tcap  # noqa: E402
from vidgraph_tpu_torch.models import checkpoint as tck  # noqa: E402
from vidgraph_tpu_torch.services import llm_client as tllm  # noqa: E402

ROOT = Path(__file__).parent.parent
JCFG = jcap.CaptionerConfig(width=32, layers=2, heads=2, vision_dim=32,
                            num_vision_tokens=2, max_len=640,
                            dtype=jnp.float32)
TCFG = tcap.CaptionerConfig(width=32, layers=2, heads=2, vision_dim=32,
                            num_vision_tokens=2, max_len=640,
                            dtype=torch.float32)


def _plant_bigram(p):
    """Random weights with a planted byte bigram, so that greedy decode
    writes ``view| dark| dark`` lines after a prompt's final newline: a
    triplet whose words the golden captions contain, so the refiner's
    grounding guard keeps it and the KG build has something to build.
    Each byte of the chain gets a large zero-mean embedding direction of
    its own; the head maps that direction to the byte's successor (``k``:
    ``|``, or a newline where the grammar forbids ``|``).  Everything
    else stays random."""
    chain = {"\n": "v", "v": "i", "i": "e", "e": "w", "w": "|", "|": " ",
             " ": "d", "d": "a", "a": "r", "r": "k", "k": "|"}
    tok, head = np.array(p["tok_emb"]), np.array(p["head_w"])
    for i, (byte, nxt) in enumerate(chain.items()):
        u = np.zeros(head.shape[0], np.float32)
        u[2 * i], u[2 * i + 1] = 1.0, -1.0
        tok[ord(byte)] = 30.0 * u
        head[:, ord(nxt)] += 2.0 * u
    head[:, ord("\n")] += 1.0 * tok[ord("k")] / 30.0
    return {**p, "tok_emb": jnp.asarray(tok), "head_w": jnp.asarray(head)}


@pytest.fixture(scope="module")
def clients():
    jp = _plant_bigram(jcap.init_params(JCFG, seed=11))
    tp = captioner_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return (jllm.TPUChatClient(cfg=JCFG, params=jp, max_new=32),
            tllm.TPUChatClient(cfg=TCFG, params=tp, max_new=32))


PROMPTS = ["one red beaker", "bench", "the blue flame heats a flask",
           "TRIPLET LINES: a person holds a beaker",
           'Answer with {"is_correct": true} or false',
           'Return {"triplets": [...]} now']


def test_batch_texts_equal_jax(clients, monkeypatch):
    jc, tc = clients
    shapes = []
    real = tcap.generate_from_tokens

    def spy(params, cfg, tokens, prompt_len, max_new, **kw):
        shapes.append((*tokens.shape, max_new, prompt_len.tolist()))
        return real(params, cfg, tokens, prompt_len, max_new=max_new, **kw)
    monkeypatch.setattr(tcap, "generate_from_tokens", spy)
    got = tc.complete_batch_sync(PROMPTS, max_tokens=16)
    assert got == jc.complete_batch_sync(PROMPTS, max_tokens=16)
    assert len(got) == len(PROMPTS) and all(isinstance(t, str) for t in got)
    b_pad, t_pad, max_new, lens = shapes[-1]
    assert (b_pad, t_pad, max_new) == (8, 64, 32)
    assert lens[6:] == [0, 0] and min(lens[:6]) > 0     # inert filler rows
    for p, text in zip(PROMPTS[:3], got):
        assert text == tc.complete_sync(p, max_tokens=16)


def test_coalesced_completes_equal_jax(clients):
    jc, tc = clients
    prompts = [f"prompt number {i} mentions a beaker" for i in range(6)]

    def run(client):
        async def go():
            return await asyncio.gather(*[
                client.complete(p, max_tokens=16) for p in prompts])
        return asyncio.run(go())
    got = run(tc)
    assert tc._batcher.stats()["batches"] < 6, "no coalescing happened"
    assert got == run(jc)


def test_decode_budget_and_prompt_fit(clients):
    _jc, tc = clients
    big = tllm.TPUChatClient(cfg=TCFG, params=clients[1].params, max_new=768)
    assert [big._decode_budget(n) for n in (1, 100, 128, 2048)] == \
        [64, 128, 128, 768]
    for text in ("é" * 500, "°C " * 300, "\U0001f600" * 150,
                 "HEAD " + "x" * 2000 + " TAIL"):
        assert tllm.fit_prompt_bytes(text, 256) == \
            jllm.fit_prompt_bytes(text, 256)
        assert len(tllm.fit_prompt_bytes(text, 256).encode()) < 256
    assert tc.max_prompt_bytes == 640 - 2 - 32 - 2
    long = "HEAD " + "x" * (tc.max_prompt_bytes + 5) + " TAIL"
    assert isinstance(tc.complete_sync(long), str)


def test_checkpoint_and_sidecar(tmp_path, clients):
    _jc, tc = clients
    path = tmp_path / "lm.npz"
    tck.save_params(tc.params, str(path))
    path.with_suffix(".json").write_text(json.dumps({"seq_len": 300,
                                                     "max_new": 32}))
    client = tllm.TPUChatClient(cfg=TCFG, checkpoint_path=str(path))
    assert client.MAX_NEW == 32
    assert client.max_prompt_bytes == 300 - 2 - 32 - 2
    loaded = dict(tck.tree_leaves(client.params))
    for k, a in tck.tree_leaves(tc.params):
        assert torch.equal(a, loaded[k]), k


def test_selector_missing_warns(tmp_path):
    """A missing selector checkpoint is skipped: no selector, and an
    answer prompt falls through to the decode."""
    client = tllm.TPUChatClient(
        cfg=TCFG, answer_selector_path=str(tmp_path / "absent.npz"))
    assert client._selector is None
    assert client._try_selector("QUESTION: q VIDEO CONTEXT: c "
                                "CONCISE ANSWER:") is None


def test_selector_present_loads_and_answers_as_jax(tmp_path, clients):
    """A present selector checkpoint (the JAX package's npz and
    ``selector_cfg`` sidecar) loads and answers the benchmark's answer
    prompts as the JAX client does, while other prompts still decode."""
    from vidgraph_tpu.models import checkpoint as jck
    from vidgraph_tpu.models import reranker as jrr
    from vidgraph_tpu.pipeline.prompts import build_benchmark_answer_prompt
    from vidgraph_tpu_torch.models.answer_selector import AnswerSelector

    present = tmp_path / "selector.npz"
    rcfg = jrr.RerankerConfig.tiny()
    jck.save_params(jrr.init_reranker_params(rcfg, seed=4), str(present))
    present.with_suffix(".json").write_text(json.dumps({"selector_cfg": {
        "width": rcfg.width, "layers": rcfg.layers, "heads": rcfg.heads,
        "max_len": rcfg.max_len, "query_budget": rcfg.query_budget}}))
    jc, tc = clients
    jsel = jllm.TPUChatClient(cfg=JCFG, params=jc.params, max_new=32,
                              answer_selector_path=str(present))
    tsel = tllm.TPUChatClient(cfg=TCFG, params=tc.params, max_new=32,
                              answer_selector_path=str(present))
    assert isinstance(tsel._selector, AnswerSelector)
    ctx = ("Found results:\nContent: The scientist pours liquid into a "
           "red beaker. (score: 0.83)\nThe balance displays 42.5 g.")
    for q in ("what color is the beaker?", "what does the balance show?"):
        prompt = build_benchmark_answer_prompt(q, ctx)
        assert tsel.complete_sync(prompt) == jsel.complete_sync(prompt)
    assert tsel.complete_sync(PROMPTS[0]) == jsel.complete_sync(PROMPTS[0])


def test_make_chat_client_tpu_serves_the_chat_config():
    client = tllm.make_chat_client("tpu")
    assert isinstance(client, tllm.TPUChatClient)
    assert client.cfg == tcap.CaptionerConfig.chat()
    assert client.params["pos_emb"].shape == (4096, 512)
    assert client.device.type == "cpu"


def _graph(store):
    return {"entities": sorted(store.entities),
            "rels": sorted("|".join(k) for k in store.rels),
            "chunks": {cid: c.get("content")
                       for cid, c in sorted(store.chunks.items())}}


def test_kg_build_through_the_chat_lm_equals_jax(tmp_path, clients):
    """``KGBuilder(config, chat_client=...)`` in both packages with
    ``config/tpu_llm_config.yaml``: pre-extraction and refinement through
    the chat LM, on the golden vlm output.  The graphs must be equal."""
    graphs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tiktoken", None)
        for name, mod, client in (("jax", (jcfg_mod, jkg, jgraph),
                                   clients[0]),
                                  ("port", (tcfg_mod, tkg, tgraph),
                                   clients[1])):
            cfg_mod, kg_mod, graph_mod = mod
            d = tmp_path / name
            d.mkdir()
            mp.chdir(d)
            cfg = cfg_mod.PipelineConfig.from_yaml(
                str(ROOT / "config" / "tpu_llm_config.yaml"))
            cfg.acs.backend = "networkx"
            cfg.graph_store.persist_dir = str(d / "gs")
            asyncio.run(kg_mod.KGBuilder(cfg, chat_client=client,
                                         run_uuid="chat")
                        .build_knowledge_graph(
                            str(ROOT / "tests/golden/vlm_output_golden.json")))
            graphs[name] = _graph(graph_mod.open_graph_store(cfg, "chat"))
    assert graphs["port"]["rels"] == ["View|DARK|Dark"]
    assert graphs["port"] == graphs["jax"]
