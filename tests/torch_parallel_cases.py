"""What the ranks of the ``test_torch_parallel_*`` modules run.

Each function here runs on every rank of a gloo group started by
``vidgraph_tpu_torch.parallel.launch.run_ranks`` and returns plain
numpy/Python values; the test modules compare rank 0's (or every rank's)
with the JAX package's, computed in the pytest process.  This module
imports torch and the port only: the ranks must not import JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vidgraph_tpu_torch.parallel import mesh as pm


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.detach().cpu().numpy().copy()


# ----------------------------------------------------------- sharded search
def search_cases(jax_inputs):
    """Every case of ``tests/test_sharded_search.py`` on a (4, 1) mesh, and
    on a 3-rank mesh (odd padding) over ranks 0-2; a store of fewer rows
    than ranks."""
    from vidgraph_tpu_torch.memory.embedding_store import EmbeddingStore
    from vidgraph_tpu_torch.parallel.sharded_search import \
        ShardedEmbeddingStore

    out = {"builders": {
        "host_cpu_mesh": tuple(pm.host_cpu_mesh(4).shape),
        "single_device_mesh": tuple(pm.single_device_mesh().shape),
        "model_axis_3": tuple(pm.build_mesh(model_axis=3).shape)}}
    mesh4 = pm.build_mesh(model_axis=1)
    mesh3 = pm.build_mesh(ranks=[0, 1, 2], model_axis=1)
    meshes = {"w4": mesh4}
    if pm.in_mesh(mesh3):
        meshes["w3"] = mesh3
    for tag, mesh in meshes.items():
        res = {}
        # test_sharded_search_matches_numpy
        inp = jax_inputs["matches_numpy"]
        store = ShardedEmbeddingStore(mesh, dim=64, capacity=1024,
                                      device_min_rows=0)
        store.add([f"i{i}" for i in range(len(inp["vecs"]))], inp["vecs"])
        res["matches_numpy"] = {
            "len": len(store),
            "padded_rows": store._padded_host().shape[0],
            "data": pm.axis_size(mesh, "data"),
            "hits": store.search(inp["q"], k=5)}
        # test_sharded_store_sharding_layout
        store = ShardedEmbeddingStore(mesh, dim=32, capacity=1024)
        store.add(["a"], np.ones((1, 32), np.float32))
        res["layout"] = {"shard_rows": store._device_store().shape[0],
                         "capacity": store.capacity,
                         "placements": [repr(p) for p in store.placements]}
        # test_sharded_empty_and_threshold
        store = ShardedEmbeddingStore(mesh, dim=16, device_min_rows=0)
        empty = store.search(np.ones((1, 16), np.float32), k=3)
        store.add(["x"], np.eye(16, dtype=np.float32)[:1])
        res["empty_threshold"] = (empty, store.search(
            -np.eye(16, dtype=np.float32)[:1], k=3, threshold=0.0))
        # test_sharded_api_parity_with_single_device
        inp = jax_inputs["api_parity"]
        plain = EmbeddingStore(dim=48)
        shard = ShardedEmbeddingStore(mesh, dim=48, device_min_rows=0)
        for s in (plain, shard):
            s.add(inp["ids"], inp["vecs"])
            s.add(["c5"], np.ones((1, 48), np.float32))
        rebuilt = EmbeddingStore.from_state(shard.state_dict())
        res["api_parity"] = {
            "ids": (shard.ids(), plain.ids()),
            "vectors": (shard.vectors(), plain.vectors()),
            "get": (shard.get("c5"), plain.get("c5")),
            "hits": (shard.search(inp["q"], k=7, threshold=-1.0),
                     plain.search(inp["q"], k=7, threshold=-1.0)),
            "sim": (shard.similarity_matrix(inp["q"]),
                    plain.similarity_matrix(inp["q"])),
            "rebuilt": (rebuilt.ids(), rebuilt.vectors())}
        # test_sharded_growth_keeps_divisible_mirror
        inp = jax_inputs["growth"]
        store = ShardedEmbeddingStore(mesh, dim=8, capacity=1024,
                                      device_min_rows=0)
        store.add([f"g{i}" for i in range(len(inp["vecs"]))], inp["vecs"])
        res["growth"] = {"capacity": store.capacity,
                         "padded_rows": store._padded_host().shape[0],
                         "hit": store.search(store.get("g42")[None], k=1)}
        # fewer live rows than ranks: shards past the count hold no row
        inp = jax_inputs["small"]
        store = ShardedEmbeddingStore(mesh, dim=16, device_min_rows=0)
        plain = EmbeddingStore(dim=16)
        for s in (store, plain):
            s.add(["s0", "s1"], inp["vecs"])
        res["small"] = (store.search(inp["q"], k=5),
                        plain.search(inp["q"], k=5),
                        store.similarity_matrix(inp["q"]))
        out[tag] = res
    return out if pm.rank() == 0 else None


# ------------------------------------------------------------------ serving
def serving_cases(inputs):
    """``tests/test_mesh_serving.py``'s criteria on 2 ranks."""
    from vidgraph_tpu_torch.core.config import PipelineConfig
    from vidgraph_tpu_torch.parallel import serving
    from vidgraph_tpu_torch.parallel.dryrun import retrieve_once

    out = {}
    # policy off / on / auto (world 2: auto is on)
    serving.configure(enabled=False)
    off = serving.serving_mesh()
    serving.configure(enabled=True, model_axis=2)
    on = serving.serving_mesh()
    on_store = type(serving.make_embedding_store(dim=16)).__name__
    serving.configure(enabled=False)
    off_store = type(serving.make_embedding_store(dim=16)).__name__
    serving.configure(enabled="auto", model_axis=1)
    auto = serving.serving_mesh()
    out["policy"] = {"off": off is None,
                     "on_model": pm.axis_size(on, "model"),
                     "on_store": on_store, "off_store": off_store,
                     "auto_shape": tuple(auto.shape)}
    # the config load configures serving
    PipelineConfig.from_dict({"mesh": {"enabled": False}})
    cfg_off = serving.serving_mesh() is None
    PipelineConfig.from_dict({"mesh": {"enabled": True, "model_axis": 2}})
    out["config"] = {"off": cfg_off, "on_model": pm.axis_size(
        serving.serving_mesh(), "model")}
    # hybrid retrieval through the mesh == single device
    serving.configure(enabled=True, model_axis=2)
    out["retrieval_mesh"] = retrieve_once()
    serving.configure(enabled=False)
    out["retrieval_single"] = retrieve_once()
    # the tiny64 VLM caption, tensor-parallel over 2 ranks
    from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient

    frames = [np.full((48, 48, 3), v, np.uint8) for v in (40, 200)]
    serving.configure(enabled=True, model_axis=2)
    tp = TPUVLMClient(preset="tiny64", max_new=16,
                      checkpoint=inputs["vlm_npz"])
    out["vlm_split"] = (tp._mesh is not None,
                        tp.cap_params["blocks"][0]["qkv_w"].shape[1],
                        tp.vit.block_0.attn.qkv.split)
    out["vlm_tp"] = tp.caption_batch_sync([frames])
    serving.configure(enabled=False)
    sd = TPUVLMClient(preset="tiny64", max_new=16,
                      checkpoint=inputs["vlm_npz"])
    out["vlm_single"] = sd.caption_batch_sync([frames])
    # attn_impl "fused" (kernel 5's plain version here) on local heads
    from vidgraph_tpu_torch.models.vit import ViTConfig

    fused = ViTConfig(image_size=64, patch_size=32, width=128, layers=4,
                      heads=4, embed_dim=64, dtype=torch.float32,
                      attn_impl="fused")
    captions = []
    for enabled in (True, False):
        serving.configure(enabled=enabled, model_axis=2)
        client = TPUVLMClient(vit_cfg=fused, preset="tiny64", max_new=16,
                              checkpoint=inputs["vlm_npz"])
        captions.append(client.caption_batch_sync([frames]))
    out["vlm_fused"] = captions
    # the chat decode (generate_from_tokens), tensor-parallel
    from vidgraph_tpu_torch.convert import captioner_params_from_jax
    from vidgraph_tpu_torch.models.captioner import CaptionerConfig
    from vidgraph_tpu_torch.services.llm_client import TPUChatClient

    cfg = CaptionerConfig(width=128, layers=2, heads=4, vision_dim=64,
                          num_vision_tokens=2, max_len=640,
                          dtype=torch.float32)
    prompt = "Extract triplets: the person holds a red beaker."
    serving.configure(enabled=True, model_axis=2)
    chat = TPUChatClient(cfg=cfg, params=captioner_params_from_jax(
        inputs["chat_params"]), max_new=16)
    out["chat_tp"] = (chat._mesh is not None, chat.complete_sync(prompt))
    serving.configure(enabled=False)
    chat = TPUChatClient(cfg=cfg, params=captioner_params_from_jax(
        inputs["chat_params"]), max_new=16)
    out["chat_single"] = chat.complete_sync(prompt)
    serving.configure(enabled="auto", model_axis=1)
    out["cli"] = cli_cases(inputs)
    return out


def cli_cases(inputs):
    """``kg`` through the CLI on every rank: rank 0 alone prints the UUID
    and persists the graph; ``stream`` on every rank: rank 0 alone prints
    its JSON."""
    import contextlib
    import io
    import os

    import torch.distributed as dist

    from vidgraph_tpu_torch.cli.main import main

    os.chdir(inputs["workdir"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["kg", "--config", inputs["kg_config"], "--vlm-output",
              inputs["vlm_output"]])
    dist.barrier()
    out = {"stdout": buf.getvalue(), "graphs": sorted(os.listdir("gs"))}
    # batch-retrieve on rank 0's graph: the follower reads a copy of it
    uuid = [out["stdout"].split("UUID: ")[1].split()[0]
            if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(uuid, src=0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["batch-retrieve", "--config", inputs["kg_config"],
              "--graph-uuid", uuid[0], "--input", inputs["queries"],
              "--output", "retrieval.json"])
    dist.barrier()
    out["retrieve_stdout"] = buf.getvalue()
    out["written"] = sorted(p for p in os.listdir(".") if p != "gs")
    out["metrics"] = os.listdir("metrics")
    out["stream_stdout"] = stream_cli(inputs)
    out["serve"] = serve_cli(inputs)
    return out


def serve_cli(inputs) -> dict:
    """``serve`` through the CLI on every rank.  On rank 0 a client thread
    waits for the port, persists a graph into rank 0's graph directory
    (after the server started), ingests, queries and retrieves that graph,
    then interrupts the server (SIGINT): the leader's ``STOP`` ends the
    follower's ``serve``, which returns."""
    import asyncio
    import contextlib
    import io
    import json
    import os
    import shutil
    import signal
    import socket
    import threading
    import time

    import torch.distributed as dist

    from vidgraph_tpu_torch.cli.main import main

    port, responses = inputs["serve_port"], []

    async def request(method, path, body=None):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        payload = json.dumps(body).encode() if body is not None else b""
        writer.write((f"{method} {path} HTTP/1.1\r\nContent-Length: "
                      f"{len(payload)}\r\nConnection: close\r\n\r\n"
                      ).encode() + payload)
        await writer.drain()
        head, _, data = (await reader.read()).partition(b"\r\n\r\n")
        writer.close()
        return int(head.split(b" ")[1]), json.loads(data)

    def client():
        try:
            for _ in range(600):
                with contextlib.suppress(OSError), \
                        socket.create_connection(("127.0.0.1", port)):
                    break
                time.sleep(0.1)
            for f in os.listdir(inputs["graph_src"]):
                shutil.copy(os.path.join(inputs["graph_src"], f), "gs")
            for req in inputs["serve_requests"]:
                responses.append(asyncio.run(request(*req)))
        finally:
            os.kill(os.getpid(), signal.SIGINT)

    out = {"interrupted": False}
    if dist.get_rank() == 0:
        threading.Thread(target=client, daemon=True).start()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out["rc"] = main(["serve", "--config", inputs["kg_config"],
                              "--port", str(port)])
    except KeyboardInterrupt:
        out["interrupted"] = True
    out.update(stdout=buf.getvalue(), responses=responses)
    return out


def stream_cli(inputs) -> str:
    """What ``stream`` through the CLI prints on this rank: two streams of
    one video, a query to each."""
    import contextlib
    import io

    from vidgraph_tpu_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["stream", "--config", inputs["stream_config"], "--videos",
              inputs["video"], inputs["video"], "--fps", "5", "--query",
              "1.5:0:a red shape", "--query", "2.5:1:a blue shape"])
    return buf.getvalue()


def world_one_cases(inputs):
    """At a world of one: ``enabled: true`` starts a world-1 group, the
    stream engine's memories are row-sharded stores; ``stream`` through
    the CLI (no mesh at a world of one under ``auto``)."""
    import torch.distributed as dist

    from vidgraph_tpu_torch.parallel import serving
    from vidgraph_tpu_torch.services.embed_client import make_embed_client
    from vidgraph_tpu_torch.streams.realtime import RealtimeEngine, \
        StreamSpec

    pm.shutdown()       # the launcher's group: start from none
    before = dist.is_initialized()
    serving.configure(enabled=True, model_axis=1)
    mesh = serving.serving_mesh()
    eng = RealtimeEngine([StreamSpec("s0", fps=2.0, frames_per_chunk=2,
                                     height=24, width=32)],
                         make_embed_client("hash", dim=32))
    out = {"before": before, "world": dist.get_world_size(),
           "shape": tuple(mesh.shape),
           "memory": type(eng.memories["s0"]).__name__}
    serving.configure(enabled="auto", model_axis=1)
    out["stream_stdout"] = stream_cli(inputs)
    return out


# ------------------------------------------------------------------ training
def train_cases(inputs):
    """``TrainState`` on a (2, 2) mesh from the JAX package's weights:
    the loss of each of 3 steps, the whole tree after steps 1 and 3."""
    from vidgraph_tpu_torch.convert import (captioner_params_from_jax,
                                            vit_params_from_jax)
    from vidgraph_tpu_torch.models.captioner import CaptionerConfig
    from vidgraph_tpu_torch.models.train import TrainState
    from vidgraph_tpu_torch.models.vit import ViTConfig, VisionTower

    mesh = pm.build_mesh(model_axis=2)
    vit_cfg = ViTConfig(**inputs["vit_cfg"], dtype=torch.float32)
    cap_cfg = CaptionerConfig(**inputs["cap_cfg"], dtype=torch.float32)
    tower = VisionTower(vit_cfg)
    tower.load_state_dict(vit_params_from_jax(inputs["vit"]))
    cap = captioner_params_from_jax(inputs["cap"])
    state = TrainState.from_models(tower, cap, vit_cfg, cap_cfg,
                                   learning_rate=inputs["lr"],
                                   weight_decay=0.01,
                                   mesh=mesh)
    batch = state.shard_batch(inputs["images"], inputs["tokens"])
    losses, trees = [], {}
    for step in (1, 2, 3):
        state, loss = state.step(*batch)
        losses.append(loss)
        if step in (1, 3):
            trees[step] = _np_tree(state.checkpoint_tree())
    local = {"qkv_w": tuple(state.params["cap"]["blocks"][0]["qkv_w"]
                            .shape),
             "rows": tuple(batch[0].shape)}
    return {"losses": losses, "trees": trees, "local": local} \
        if pm.rank() == 0 else {"losses": losses, "local": local}


def moe_cases(inputs):
    """The MoE FFN over a 4-expert mesh and its gradient over a 2-expert
    mesh, against the whole FFN on the same rank."""
    from vidgraph_tpu_torch.parallel.moe import (moe_ffn,
                                                 moe_params_from_jax,
                                                 place_experts)

    out = {}
    ep4 = pm.mesh_of(torch.arange(4).reshape(1, 4), ("rep", "expert"))
    p = moe_params_from_jax(inputs["fwd_params"])
    x = torch.from_numpy(inputs["fwd_x"])
    with torch.no_grad():
        whole = moe_ffn(p, x)
        with pm.use_mesh(ep4):
            sharded = moe_ffn(place_experts(p, ep4), x)
    out["fwd"] = (whole.numpy(), sharded.numpy(),
                  tuple(place_experts(p, ep4)["w_in"].shape))
    p = moe_params_from_jax(inputs["route_params"])
    top = torch.argmax(torch.from_numpy(inputs["route_x"]) @ p["router_w"],
                       dim=-1)
    out["experts_used"] = int(torch.unique(top).numel())
    # gradients: the whole FFN's against the sharded one's
    ep2 = pm.mesh_of(torch.arange(4).reshape(2, 2), ("rep", "expert"))
    x = torch.from_numpy(inputs["grad_x"])
    whole = {k: v.clone().requires_grad_(True) for k, v in
             moe_params_from_jax(inputs["grad_params"]).items()}
    (moe_ffn(whole, x) ** 2).mean().backward()
    local = place_experts({k: v.detach().requires_grad_(True)
                           for k, v in whole.items()}, ep2)
    local = {k: v.detach().clone().requires_grad_(True)
             for k, v in local.items()}
    with pm.use_mesh(ep2):
        (moe_ffn(local, x) ** 2).mean().backward()
    group = pm.axis_group(ep2, "expert")
    from vidgraph_tpu_torch.parallel import comm

    sharded_grads = {
        "router_w": local["router_w"].grad.numpy(),
        **{k: torch.cat(comm.all_gather(local[k].grad, group)).numpy()
           for k in ("w_in", "w_out")}}
    out["grad"] = ({k: v.grad.numpy() for k, v in whole.items()},
                   sharded_grads)
    return out if pm.rank() == 0 else None


def pipeline_cases(inputs):
    """GPipe at (stages, micro) in (2, 2), (4, 4), (2, 4) against the
    sequential stack; the gradient of mean(y^2); invalid shapes."""
    from vidgraph_tpu_torch.convert import captioner_params_from_jax
    from vidgraph_tpu_torch.models.captioner import CaptionerConfig, _block
    from vidgraph_tpu_torch.parallel.pipeline import (captioner_block_fn,
                                                      pipeline_forward,
                                                      stack_block_params)

    cfg = CaptionerConfig(width=32, layers=4, heads=2, vision_dim=32,
                          num_vision_tokens=2, max_len=16,
                          dtype=torch.float32)
    t = 8
    idx = torch.arange(t)
    mask = torch.where(idx[None, :] <= idx[:, None], 0.0, -1e30)
    meshes = {2: pm.mesh_of(torch.arange(4).reshape(2, 2), ("rep", "pipe")),
              4: pm.mesh_of(torch.arange(4).reshape(1, 4), ("rep", "pipe"))}
    out = {"fwd": {}}
    params = captioner_params_from_jax(inputs["params"])
    x = torch.from_numpy(inputs["x"])
    with torch.no_grad():
        ref = x
        for bp in params["blocks"]:
            ref = _block(bp, cfg, ref, mask=mask)[0]
        for stages, micro in ((2, 2), (4, 4), (2, 4)):
            got = pipeline_forward(captioner_block_fn(cfg, mask),
                                   stack_block_params(params["blocks"]), x,
                                   meshes[stages], n_microbatches=micro)
            out["fwd"][(stages, micro)] = got.numpy()
    out["seq"] = ref.numpy()
    # the gradient of mean(y^2) against the sequential stack's
    gcfg = dataclasses.replace(cfg, layers=2)
    gparams = captioner_params_from_jax(inputs["grad_params"])
    gx = torch.from_numpy(inputs["grad_x"])
    stacked = {k: v.clone().requires_grad_(True) for k, v in
               stack_block_params(gparams["blocks"]).items()}
    y = pipeline_forward(captioner_block_fn(gcfg, mask), stacked, gx,
                         meshes[2], n_microbatches=2)
    (y ** 2).mean().backward()
    seq = {k: v.detach().clone().requires_grad_(True)
           for k, v in stack_block_params(gparams["blocks"]).items()}
    h = gx
    for i in range(gcfg.layers):
        h = _block({k: v[i] for k, v in seq.items()}, gcfg, h, mask=mask)[0]
    (h ** 2).mean().backward()
    out["grad"] = ({k: v.grad.numpy() for k, v in stacked.items()},
                   {k: v.grad.numpy() for k, v in seq.items()})
    # invalid shapes raise before any collective
    errors = []
    for blocks, micro in ((params["blocks"][:3], 2), (params["blocks"], 3)):
        try:
            pipeline_forward(captioner_block_fn(cfg, mask),
                             stack_block_params(blocks),
                             torch.zeros(4, 8, 32), meshes[2],
                             n_microbatches=micro)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["invalid"] = errors
    return out if pm.rank() == 0 else None


def train_moe_pipeline_cases(inputs):
    return {"train": train_cases(inputs["train"]),
            "moe": moe_cases(inputs["moe"]),
            "pipeline": pipeline_cases(inputs["pipeline"])}


def rank_one_fails():
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    dist.barrier()
