"""The multichip dry-run on ``torch.distributed``.

Counterpart of ``__graft_entry__.py``'s ``dryrun_multichip`` and
``_dryrun_impl``: ``dryrun_multichip(n)`` starts n ranks
(``parallel/launch.py``; gloo on the CPU, or NCCL when n cards are
present) and each runs ``_dryrun_impl(n)``, every check of the JAX
dry-run at its shapes:

* one training step of ViT -> captioner on a (data, model) mesh, and the
  loss with the token sequence sharded over "model" (it must not change);
* the MoE FFN with experts over an "expert" mesh against the whole FFN;
* the GPipe forward over a 2-stage "pipe" mesh against the sequential
  stack;
* the row-sharded embedding store against a host argsort;
* one hybrid retrieval through the serving mesh, equal to single-device;
* a tensor-parallel caption decode and a ragged, grammar-constrained chat
  batch, token-equal to single-device;
* the capacity scaling: a per-device row budget that only the sharded
  store can serve, searched exactly.

Rank 0 prints the summary lines and ``dryrun_multichip`` returns them.

    python -m vidgraph_tpu_torch.parallel.dryrun [N]
"""
from __future__ import annotations

import math
import sys
from typing import List, Optional

import numpy as np
import torch


def dryrun_multichip(n_devices: int, deadline_s: float = 900.0) -> List[str]:
    """Run the dry-run on ``n_devices`` ranks; returns rank 0's summary
    lines (also printed)."""
    use_cards = (torch.cuda.is_available()
                 and torch.cuda.device_count() >= n_devices)
    from .launch import run_ranks

    if use_cards:
        from ..ops import _build

        _build.library()     # built once here, before the ranks load it
    results = run_ranks("vidgraph_tpu_torch.parallel.dryrun:_dryrun_impl",
                        n_devices, (n_devices,),
                        backend="nccl" if use_cards else "gloo",
                        device="cuda" if use_cards else "cpu",
                        timeout_s=120.0, deadline_s=deadline_s)
    for line in results[0]:
        print(line)
    return results[0]


def _dryrun_impl(n_devices: int) -> List[str]:
    import dataclasses
    import torch.distributed as dist

    from ..core import prng
    from ..models.captioner import CaptionerConfig, _block, generate, \
        init_params
    from ..models.tokenizer import batch_encode
    from ..models.train import TrainState
    from ..models.vit import ViTConfig
    from . import serving
    from .mesh import mesh_of, rank, use_mesh
    from .moe import init_moe_params, moe_ffn, place_experts
    from .pipeline import (captioner_block_fn, pipeline_forward,
                           stack_block_params)
    from .sharded_search import ShardedEmbeddingStore

    assert dist.get_world_size() == n_devices, (
        f"need {n_devices} ranks, have {dist.get_world_size()}")
    model_axis = 2 if n_devices % 2 == 0 else 1
    data_axis = n_devices // model_axis
    ranks = torch.arange(n_devices)
    mesh = mesh_of(ranks.reshape(data_axis, model_axis), ("data", "model"))

    # tiny flagship stack; widths divisible by the model axis
    vit_cfg = ViTConfig(image_size=64, patch_size=32, width=64, layers=2,
                        heads=2, embed_dim=32, dtype=torch.float32)
    cap_cfg = CaptionerConfig(width=64, layers=2, heads=2, vision_dim=32,
                              num_vision_tokens=2, max_len=32,
                              dtype=torch.float32)
    state = TrainState.create(vit_cfg, cap_cfg, mesh=mesh,
                              learning_rate=1e-3)
    batch = 2 * data_axis
    rng = np.random.default_rng(0)
    images = rng.normal(size=(batch, 64, 64, 3)).astype(np.float32)
    tokens = batch_encode(["a tiny training caption"] * batch, 16)
    state, loss = state.step(*state.shard_batch(images, tokens))
    assert math.isfinite(loss), f"non-finite loss: {loss}"

    # sequence parallelism: the token sequence sharded over 'model'; the
    # loss must be unchanged
    sp_note = ""
    if model_axis > 1:
        from . import comm
        from .mesh import axis_group

        with torch.no_grad():
            dp = axis_group(mesh, "data")
            l_full = comm.all_reduce(state.loss(
                *state.shard_batch(images, tokens)).clone(), dp).item()
            l_sp = comm.all_reduce(state.loss(
                *state.shard_batch(images, tokens, sequence_parallel=True),
                sequence_parallel=True).clone(), dp).item()
        assert math.isfinite(l_sp) and abs(l_sp - l_full) < 1e-6, \
            (l_sp, l_full)
        sp_note = f" sp loss={l_sp:.4f}"

    # expert parallelism: the MoE FFN over an 'expert' mesh must match the
    # whole FFN
    n_exp = min(4, n_devices)
    ep_mesh = mesh_of(ranks.reshape(-1, n_exp), ("rep", "expert"))
    moe_params = init_moe_params(prng.PRNGKey(0), d_model=32, d_hidden=64,
                                 n_experts=n_exp)
    xe = prng.normal(prng.PRNGKey(1), (2, 8, 32))
    with torch.no_grad():
        ref_moe = moe_ffn(moe_params, xe)
        with use_mesh(ep_mesh):
            got_moe = moe_ffn(place_experts(moe_params, ep_mesh), xe)
    ep_err = float((got_moe - ref_moe).abs().max())
    assert ep_err < 1e-4, f"expert-parallel mismatch: {ep_err}"

    # pipeline parallelism: GPipe over a 2-stage 'pipe' mesh must match
    # the sequential block stack
    pp_note = ""
    if n_devices >= 2 and n_devices % 2 == 0:
        pipe_mesh = mesh_of(ranks.reshape(-1, 2), ("rep", "pipe"))
        pp_params = init_params(cap_cfg, seed=0)
        x = torch.from_numpy(rng.normal(size=(4, 8, cap_cfg.width))
                             .astype(np.float32))
        idx = torch.arange(8)
        mask = torch.where(idx[None, :] <= idx[:, None], 0.0, -1e30)
        with torch.no_grad():
            ref = x
            for bp in pp_params["blocks"]:
                ref = _block(bp, cap_cfg, ref, mask=mask)[0]
            got = pipeline_forward(captioner_block_fn(cap_cfg, mask),
                                   stack_block_params(pp_params["blocks"]),
                                   x, pipe_mesh, n_microbatches=2)
        err = float((got - ref).abs().max())
        assert err < 1e-3, f"pipeline-parallel mismatch: {err}"
        pp_note = f" pp(2-stage) err={err:.2e}"

    # the row-sharded embedding store against a host argsort
    rng2 = np.random.default_rng(2)
    vecs = rng2.normal(size=(64, 32)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    sstore = ShardedEmbeddingStore(mesh, dim=32, capacity=128,
                                   device_min_rows=0)
    sstore.add([f"r{i}" for i in range(64)], vecs)
    q = rng2.normal(size=(1, 32)).astype(np.float32)
    hits = sstore.search(q, k=4)[0]
    qn = q[0] / np.linalg.norm(q[0])
    want = set(np.argsort(-(vecs @ qn))[:4].tolist())
    got_ids = {int(h[0][1:]) for h in hits}
    assert got_ids == want, (got_ids, want)

    # ---- serving path THROUGH the mesh ------------------------------------
    # (a) one hybrid retrieval with the serving mesh active equals the
    # single-device retrieval
    serving.configure(enabled=True, model_axis=model_axis)
    assert serving.serving_mesh() is not None
    mesh_result, mesh_store_cls = retrieve_once()
    assert mesh_store_cls == "ShardedEmbeddingStore", mesh_store_cls
    serving.configure(enabled=False)
    single_result, single_store_cls = retrieve_once()
    assert single_store_cls == "EmbeddingStore", single_store_cls
    assert mesh_result == single_result, (
        "mesh-routed hybrid retrieval diverged from single-device:\n"
        f"mesh:   {mesh_result!r}\nsingle: {single_result!r}")

    # (b) one caption decode with tensor-parallel weights over 'model'
    # gives the single-device tokens
    from .serving import shard_captioner_params

    cap_params = init_params(cap_cfg, seed=1)
    vis = torch.from_numpy(rng.normal(
        size=(2, cap_cfg.num_vision_tokens, cap_cfg.vision_dim))
        .astype(np.float32))
    ref_toks = generate(cap_params, cap_cfg, vis, max_new=12)
    tp_params = shard_captioner_params(cap_params, mesh,
                                       heads=cap_cfg.heads)
    with use_mesh(mesh):
        tp_toks = generate(tp_params, cap_cfg, vis, max_new=12)
    assert torch.equal(ref_toks, tp_toks), (
        f"tp caption decode mismatch:\n{ref_toks}\nvs\n{tp_toks}")

    # (c) the serving decode: ragged prompts through
    # TPUChatClient.complete_batch_sync (filler rows, per-row grammar)
    chat_cfg = dataclasses.replace(cap_cfg, max_len=512)
    serving.configure(enabled=True, model_axis=model_axis)
    mesh_outs = serve_batch(chat_cfg)
    serving.configure(enabled=False)
    single_outs = serve_batch(chat_cfg)
    assert mesh_outs == single_outs, (
        "mesh ragged-batch serve diverged from single-device:\n"
        f"mesh:   {mesh_outs!r}\nsingle: {single_outs!r}")
    import json

    assert json.loads(mesh_outs[0])["is_correct"] in (True, False)
    assert json.loads(mesh_outs[2]).keys() == {"triplets"}
    for line in mesh_outs[1].splitlines():
        if line:
            assert line.count("|") == 2, mesh_outs[1]

    cap_line = capacity_scaling(n_devices)
    lines = [cap_line,
             f"dryrun_multichip({n_devices}): mesh=({data_axis}x"
             f"{model_axis}) dp+tp loss={loss:.4f}{sp_note} ep err="
             f"{ep_err:.2e}{pp_note} sharded-search OK; serving-mesh hybrid "
             f"retrieval == single-device; tp caption decode == "
             f"single-device; ragged grammar-constrained batch serve (tp) "
             f"== single-device"]
    return lines if rank() == 0 else []


def retrieve_once():
    """One hybrid retrieval over a 6-chunk graph; returns (the result,
    the chunk memory's class name)."""
    import asyncio

    from ..core.config import RetrievalConfig
    from ..graph.embedded import EmbeddedGraphStore
    from ..pipeline.retriever_hybrid import HybridRetriever
    from ..services.embed_client import make_embed_client

    embed = make_embed_client("hash", dim=64)
    store = EmbeddedGraphStore("dryrun-mesh", persist_dir=None,
                               persist=False, dim=64)
    colors = ["red", "green", "blue", "white", "gray", "cyan"]
    texts = [f"the {c} beaker sits on bench {i} in the lab"
             for i, c in enumerate(colors)]
    embs = embed.embed(texts)
    trips = [{"head": f"{c} beaker", "relation": "sits on",
              "tail": f"bench {i}", "source_chunks": [f"d_{i}_0"]}
             for i, c in enumerate(colors)]
    chunks = [{"id": f"d_{i}_0", "content": t, "index": 0,
               "embedding": [float(x) for x in embs[i]]}
              for i, t in enumerate(texts)]
    store.add_batch_to_graph(trips, [{"time": "00:00-00:05"}],
                             batch_idx=0, text_chunks=chunks)
    store._chunk_emb.device_min_rows = 0
    rcfg = RetrievalConfig(use_reranker=False, post_compression=False)
    retr = HybridRetriever(rcfg, store, embed, None, output_file=None)
    result, _ = asyncio.run(
        retr.perform_hybrid_retrieval("Where is the blue beaker?"))
    return result, type(store._chunk_emb).__name__


RAGGED_PROMPTS = [
    'Judge it. Respond {"is_correct": true/false}.',
    ('Extract triplets.\nTEXT TO ANALYSE:\nThe lab technician holds '
     'a beaker.\nTRIPLET LINES:'),
    ('Consolidate. Return JSON {"triplets": [...]} \n'
     'CANDIDATE TRIPLETS:\n[["A", "near", "B", []]]\nDO THIS:'),
]


def serve_batch(chat_cfg) -> list:
    from ..models.captioner import init_params
    from ..services.llm_client import TPUChatClient

    params = init_params(chat_cfg, seed=0)
    cli = TPUChatClient(cfg=chat_cfg, params=params, max_new=48,
                        max_batch=4)
    return cli.complete_batch_sync(RAGGED_PROMPTS, max_tokens=48)


def capacity_scaling(n_devices: int) -> str:
    """A per-device row budget: the whole corpus exceeds what one device
    may hold, so only the row-sharded store serves it; search latency at
    one device and at n, and the exact top-k on the over-budget corpus."""
    import time

    from .mesh import build_mesh, single_device_mesh
    from .sharded_search import ShardedEmbeddingStore

    budget_rows = 8192
    dim_c = 256
    total_rows = budget_rows * n_devices
    rng3 = np.random.default_rng(3)
    corpus = rng3.normal(size=(total_rows, dim_c)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    qs = rng3.normal(size=(4, dim_c)).astype(np.float32)

    def run(mesh, rows: int, devices: int):
        per_dev = rows // devices
        assert per_dev <= budget_rows, (
            f"{per_dev} rows/device exceeds the {budget_rows} budget")
        s = ShardedEmbeddingStore(mesh, dim=dim_c, capacity=rows,
                                  device_min_rows=0)
        s.add([f"c{i}" for i in range(rows)], corpus[:rows])
        s.search(qs, k=8)
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            hits = s.search(qs, k=8)
        return per_dev, (time.perf_counter() - t0) / reps * 1e3, hits

    per1, lat1, _ = run(single_device_mesh(), budget_rows, 1)
    pern, latn, hits_n = run(build_mesh(model_axis=1), total_rows,
                             n_devices)
    qn0 = qs[0] / np.linalg.norm(qs[0])
    want_top = set(np.argsort(-(corpus @ qn0))[:8].tolist())
    got_top = {int(h[0][1:]) for h in hits_n[0]}
    assert got_top == want_top, (got_top, want_top)
    return (f"capacity-scaling (budget {budget_rows} rows/device, dim "
            f"{dim_c}): 1 device -> {budget_rows} rows ({per1}/dev) "
            f"p50 {lat1:.2f} ms | {n_devices} devices -> {total_rows} rows "
            f"({pern}/dev, {n_devices}x one device's budget) p50 "
            f"{latn:.2f} ms, exact top-k == host argsort")


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dryrun_multichip(int(argv[0]) if argv else 8)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
