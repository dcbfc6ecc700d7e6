"""Seeded results of the port equal the JAX package's, on the CPU: the
weight trees a seed draws (captioner, vision tower, MoE, the encoders,
``TrainState``), Louvain's masks and communities, and the seeded tiny
``TPUVLMClient``'s captions.  Both packages draw from JAX's threefry
stream (the port through ``vidgraph_tpu_torch/core/prng.py``).

Tolerances: float leaves within 2 ulp with at least 90 % bit-equal (all
were bit-equal on this host), bfloat16 leaves equal, masks and labels
equal, Louvain's modularity within 1e-6, captions equal as text.  The last
test recomputes ``tests/torch_jax_draws.json``'s JAX draws, Louvain run
and weight statistics (``tests/make_torch_jax_draws.py``) and requires the
committed file to hold the same, so the card's checks cannot drift from
JAX.
"""
import json
import os
from pathlib import Path

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import networkx as nx  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import vidgraph_tpu.pipeline.acs as jacs  # noqa: E402
import vidgraph_tpu_torch.pipeline.acs as tacs  # noqa: E402
from vidgraph_tpu.core.config import ACSConfig as JConfig  # noqa: E402
from vidgraph_tpu.graph.embedded import EmbeddedGraphStore as JStore  # noqa: E402,E501
from vidgraph_tpu.models import answer_selector as jsel  # noqa: E402
from vidgraph_tpu.models import captioner as jcap  # noqa: E402
from vidgraph_tpu.models import reranker as jrr  # noqa: E402
from vidgraph_tpu.models import text_embedder as jte  # noqa: E402
from vidgraph_tpu.models import vit as jvit  # noqa: E402
from vidgraph_tpu.parallel import moe as jmoe  # noqa: E402
from vidgraph_tpu.services import vlm_client as jvc  # noqa: E402
from vidgraph_tpu_torch.core import prng  # noqa: E402
from vidgraph_tpu_torch.core.config import ACSConfig as TConfig  # noqa: E402
from vidgraph_tpu_torch.graph.embedded import EmbeddedGraphStore as TStore  # noqa: E402,E501
from vidgraph_tpu_torch.models import answer_selector as tsel  # noqa: E402
from vidgraph_tpu_torch.models import captioner as tcap  # noqa: E402
from vidgraph_tpu_torch.models import checkpoint as tck  # noqa: E402
from vidgraph_tpu_torch.models import reranker as trr  # noqa: E402
from vidgraph_tpu_torch.models import text_embedder as tte  # noqa: E402
from vidgraph_tpu_torch.models import vit as tvit  # noqa: E402
from vidgraph_tpu_torch.models.train import TrainState  # noqa: E402
from vidgraph_tpu_torch.parallel import moe as tmoe  # noqa: E402
from vidgraph_tpu_torch.services import vlm_client as tvc  # noqa: E402

from make_torch_jax_draws import (OUT, draws, louvain,  # noqa: E402
                                  leaf_record, trees)
from test_torch_acs import _pad, jax_masks  # noqa: E402
from test_torch_prng import ulps  # noqa: E402

Q_TOL = 1e-6


def _flat_jax(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def assert_trees_equal(port: dict, ref: dict) -> None:
    """Every leaf of ``port`` (key -> tensor) against ``ref`` (key ->
    JAX array): the same keys, shapes and dtypes; float32 within 2 ulp
    with >= 90 % bit-equal, bfloat16 equal."""
    assert set(port) == set(ref)
    equal = total = 0
    for key, want in ref.items():
        got = port[key].detach()
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, key
        if got.dtype == torch.bfloat16:
            assert want.dtype.name == "bfloat16", key
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                want.view(np.int16), err_msg=key)
            continue
        got = got.numpy()
        assert got.dtype == want.dtype == np.float32, key
        assert int(ulps(got, want).max(initial=0)) <= 2, key
        equal += int((got == want).sum())
        total += got.size
    assert equal >= 0.9 * total, (equal, total)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_captioner_init_equals_jax(seed, dtype):
    tp = tcap.init_params(tcap.CaptionerConfig.tiny(), seed,
                          param_dtype=getattr(torch, dtype))
    jp = jcap.init_params(jcap.CaptionerConfig.tiny(), seed,
                          param_dtype=getattr(jnp, dtype))
    assert_trees_equal(dict(tck.tree_leaves(tp)), _flat_jax(jp))


@pytest.mark.parametrize("seed", [0, 4])
def test_vision_tower_init_equals_flax(seed):
    tower = tvit.init_vision_tower(tvit.ViTConfig.tiny(), seed)
    _, jp = jvit.init_vision_tower(jvit.ViTConfig.tiny(), seed)
    port = {"params/" + k.replace(".", "/"): v
            for k, v in tower.state_dict().items()}
    assert_trees_equal(port, _flat_jax(jp))


def test_moe_init_equals_jax():
    tp = tmoe.init_moe_params(prng.PRNGKey(0), 32, 64, 4)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), 32, 64, 4)
    assert_trees_equal(tp, _flat_jax(jp))


@pytest.mark.parametrize("seed", [0, 2])
def test_encoder_inits_equal_jax(seed):
    """The reranker's, the text embedder's and the answer selector's seed
    trees."""
    cfg = jrr.RerankerConfig.tiny()
    tcfg = trr.RerankerConfig.tiny()
    assert_trees_equal(dict(tck.tree_leaves(trr.init_reranker_params(
        tcfg, seed))), _flat_jax(jrr.init_reranker_params(cfg, seed)))
    assert_trees_equal(
        dict(tck.tree_leaves(tte.init_encoder_params(
            tcap.CaptionerConfig.tiny(), 16, seed))),
        _flat_jax(jte.init_encoder_params(jcap.CaptionerConfig.tiny(), 16,
                                          seed)))
    assert_trees_equal(
        dict(tck.tree_leaves(tsel.AnswerSelector(tcfg, seed=seed).params)),
        _flat_jax(jsel.AnswerSelector(cfg, seed=seed).params))


def test_train_state_draws_each_model_from_the_seed():
    """``TrainState.create(seed=)`` as the JAX package's: the tower and
    the captioner each from ``seed``."""
    state = TrainState.create(tvit.ViTConfig.tiny(),
                              tcap.CaptionerConfig.tiny(), "cpu", seed=5)
    _, jv = jvit.init_vision_tower(jvit.ViTConfig.tiny(), 5)
    assert_trees_equal({"params/" + k.replace(".", "/"): v
                        for k, v in state.vit.state_dict().items()},
                       _flat_jax(jv))
    assert_trees_equal(dict(tck.tree_leaves(state.params["cap"])),
                       _flat_jax(jcap.init_params(jcap.CaptionerConfig
                                                  .tiny(), 5)))


@pytest.mark.parametrize("n", [128, 1024])
def test_louvain_masks_equal_jax(n):
    tacs.louvain_masks.cache_clear()
    assert torch.equal(tacs.louvain_masks(n), jax_masks(n))


LOUVAIN_GRAPHS = {
    "karate": lambda: nx.karate_club_graph(),
    "caveman": lambda: nx.connected_caveman_graph(12, 8),
    "ba300": lambda: nx.barabasi_albert_graph(300, 2, seed=1),
    "ba926": lambda: nx.barabasi_albert_graph(926, 2, seed=0),
}


@pytest.mark.parametrize("graph", sorted(LOUVAIN_GRAPHS))
def test_default_louvain_equals_jax(graph):
    """The port's ``_louvain`` with its own masks gives JAX's labels and
    community count, and its modularity within 1e-6."""
    adj = nx.to_numpy_array(LOUVAIN_GRAPHS[graph]()).astype(np.float32)
    a, valid = _pad(adj, jacs._pad_dim(adj.shape[0]))
    jl, jq, jk = jacs._louvain(jnp.asarray(a), jnp.asarray(valid),
                               jax.random.PRNGKey(42))
    tl, tq, tk = tacs._louvain(torch.from_numpy(a), torch.from_numpy(valid))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert float(tk) == float(jk)
    assert abs(float(tq) - float(jq)) <= Q_TOL
    if graph == "ba926":
        assert int(tk) == 29 and abs(float(tq) - 0.52029) < 5e-6


def _store(cls, n_entities=120, n_rels=300, seed=3):
    """The same random graph in either package's embedded store."""
    rng = np.random.default_rng(seed)
    s = cls("acs", persist_dir=None, persist=False, dim=8)
    names = [f"E{i}" for i in range(n_entities)]
    trips = []
    for _ in range(n_rels):
        h, t = rng.choice(names, 2, replace=False)
        trips.append({"head": str(h), "relation": f"r{rng.integers(3)}",
                      "tail": str(t), "source_chunks": ["acs_0_0"]})
    chunks = [{"id": "acs_0_0", "content": "x", "index": 0,
               "embedding": [1.0] * 8}]
    s.add_batch_to_graph(trips, [{"time": "00:00-00:04", "content": "x"}],
                         0, text_chunks=chunks)
    return s


def test_update_metrics_louvain_equals_jax():
    """``ACSAutomata(backend="xla").update_metrics()``: the Louvain
    community count and modularity are the JAX package's."""
    got = tacs.ACSAutomata(_store(TStore), TConfig(backend="xla")) \
        .update_metrics()
    want = jacs.ACSAutomata(_store(JStore), JConfig(backend="xla")) \
        .update_metrics()
    assert "error" not in got and "error" not in want, (got, want)
    assert got["node_count"] == want["node_count"] >= 120
    assert got["louvain_communities"] == want["louvain_communities"] > 1
    assert got["louvain_modularity"] == want["louvain_modularity"]


def _frames(n_chunks, per_chunk, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
             for _ in range(per_chunk)] for _ in range(n_chunks)]


def test_seeded_vlm_clients_caption_equal_text():
    """No checkpoint: both clients draw their weights from seed 0 and
    caption the same frames to the same text."""
    kw = dict(seed=0, max_new=24, preprocess="device")
    jc = jvc.TPUVLMClient(jvit.ViTConfig.tiny(), jcap.CaptionerConfig.tiny(),
                          **kw)
    tc = tvc.TPUVLMClient(tvit.ViTConfig.tiny(), tcap.CaptionerConfig.tiny(),
                          **kw)
    chunks = _frames(3, 4)
    want = jc.caption_batch_sync(chunks)
    assert tc.caption_batch_sync(chunks) == want
    assert len(set(want)) > 1


def test_fixture_holds_jax_draws_louvain_and_trees():
    """``tests/torch_jax_draws.json`` as ``make_torch_jax_draws.py``
    writes it now (its captions aside: the slow part, checked on the card
    as a report)."""
    fixture = json.loads(Path(OUT).read_text())
    assert fixture["threefry_partitionable"]
    assert fixture["draws"] == draws()
    assert fixture["louvain"] == louvain()
    assert fixture["trees"] == trees()
    rows = fixture["captions"]["rows"]
    assert len(rows) == fixture["captions"]["chunks"] and all(
        len(r["tokens"]) == fixture["captions"]["max_new"] for r in rows)


def test_fixture_trees_match_the_ports_draws_of_leaves():
    """The fixture's statistics of a captioner and a tower leaf equal the
    port's own CPU draws from those leaves' keys (the card is held to the
    same statistics, leaf by leaf)."""
    leaves = json.loads(Path(OUT).read_text())["trees"]["leaves"]
    root = prng.PRNGKey(0)
    # init_params draws vis_proj_w from the third of split(root, 8 + 8 x 8)
    vis = prng.normal(prng.split(root, 8 + 8 * 8)[2], (512, 512)) * 0.02
    assert leaf_record(vis.numpy()) == leaves["cap/vis_proj_w"]
    qkv = prng.lecun_normal(prng.flax_key(root, ("block_11", "attn", "qkv"),
                                          1), (768, 2304))
    assert leaf_record(qkv.numpy()) == \
        leaves["vit/block_11/attn/qkv/kernel"]
