"""Smoke run of the PyTorch port (vidgraph_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  Phases, each failing the run on error:

1. setup: the card's name and power limit, torch and CUDA versions, and
   the build of the CUDA kernels from ``vidgraph_tpu_torch/csrc``;
2. the cosine top-k kernels against their plain PyTorch versions on the
   card, on a 200,000 x 512 float32 store made from ``--seed`` (count
   199,937), B in {1, 16, 30}, k in {1, 5, 64}, k above the count and a
   count below one tile: scores within 1e-5, indices equal where the
   neighbouring scores are more than 1e-5 apart, no masked row above
   -1e29; then median times over 20 runs (CUDA events), of the whole
   top-k and of each of its two kernels alone;
3. the main path, between a reset and a read of the launch counts:
   ``kg`` on the card from ``tests/golden/vlm_output_golden.json`` must
   rebuild ``tests/golden/pipeline_golden.json`` exactly, and ``kg`` with
   ``config/high_recall_config.yaml`` must launch the dense scoring (its
   graph must equal the CPU build's, checked after the read); then
4. the bench's reference-scale graph (600 entities, 326 chunks, 1,600
   relations; ``bench.py::_build_graph``) and its 5 warm-up and 30 timed
   queries through hybrid retrieval with vector search, post-compression
   and rerank must launch the top-k kernels at least once per query; the
   plain version must not have served.  After the read: top-5 searches of
   a 200,000-row store, and the same queries on the CPU, which must give
   the same retrieval texts;
5. the CLI in subprocesses: ``kg`` -> ``batch-retrieve`` -> ``benchmark``
   with ``config/high_recall_config.yaml`` and NetworkX ACS;
6. the FlashAttention kernel against its plain version on the card, at
   the chat LM's serving shapes (b in {1, 8, 32} x T = 2056, 8 heads of
   64, bf16, nv = 8), a ragged T = 1033 and T = 40 < nv + 64: within
   ``TOL_ABS + TOL_REL * |plain|`` (``ops/flash_attention.py``); then
   median times of both (CUDA events);
7. the on-device chat LM (``backend.llm: tpu``) at ``CaptionerConfig.
   chat()`` width, with seed-initialised weights written to an npz in the
   JAX format: ``config/tpu_llm_config.yaml`` (checkpoint and graph store
   pointed at a temp dir), through the CLI in subprocesses, ``kg`` on the
   golden vlm output -> ``batch-retrieve`` -> ``benchmark``, and one
   ``benchmark`` with ``config/judge_tpu_config.yaml`` (judge on the chat
   LM).  Random weights write no parseable triplet, so a second ``kg``
   serves the same weights with a planted byte bigram
   (``plant_bigram``), whose grounded triplet must reach the graph
   through a refinement dispatch.  Each subprocess reports its launch
   counts at exit; after the ``kg`` runs and after the benchmarks the
   flash kernel must have launched at least once per layer per dispatch
   and the plain version served no call;
8. the kernel inside the model: one b_pad 8 dispatch's prefill logits,
   with the kernel and with the plain version, within ``LOGIT_TOL``, and
   equal first tokens wherever the top-2 margin exceeds it;
9. the preprocessing kernel against its plain version: 5 and 160 frames
   of 405 x 720 (what ``io/video.py::resize_max_dim`` makes of 16:9
   video) -> 224 in the fast (bf16) and exact (float32) modes, 224^2
   (normalise only) and 120 x 160 -> 224, within ``ops/preprocess.py``'s
   tolerances; the device's time per call (``graph_ms``, 20 calls replayed
   from a CUDA graph: at these sizes CUDA events around one call mostly
   time the host's launch) of the kernel, the plain version and a library
   yardstick the port never calls
   (``F.interpolate(bilinear, antialias=True)`` and the affine), the
   CUDA-event median of a call of the kernel's wrapper, and of the uint8
   upload;
10. the short-attention kernel (tensor cores) against its plain version
   at B in {1, 5, 160} frames x 12 heads x N 50 x hd 64, bf16, and at B 5
   and 160 on the ViT's strided views of one qkv product; device times of
   both and of ``F.scaled_dot_product_attention`` as the yardstick, and
   the wrapper's call time;
11. the vision path (``backend.vlm: tpu``) at full width:
   ``ViTConfig.b32()`` and ``CaptionerConfig.base()`` with seed weights
   written as a JAX-format npz and loaded through ``vlm.checkpoint_path``
   (``preprocess: device``, ``fast_resize: true``, 256 new bytes).  The
   card's machine has no cv2, so the frame seam is replaced: in
   ``vidgraph_tpu_torch.pipeline.vlm_extractor``'s namespace only,
   ``iter_chunk_frames`` and ``count_chunks`` become a numpy source of 6
   chunks of 5 RGB uint8 frames at 405 x 720, drawn as
   ``io/video.py::write_synthetic_video`` draws them (a background of 30,
   one coloured moving square per scene).  Everything from
   ``VLMExtractor.process_video`` on is the real path.  It runs twice, with
   the default ``attn_impl='einsum'`` (through ``make_vlm_client``) and
   with ``'fused'``, each between a reset and a read of the launch counts:
   the preprocessing kernel at least once per chunk, the short-attention
   kernel 12 times per chunk in fused mode and never in einsum mode, the
   flash kernel 8 times per chunk, and no plain version.  After the reads:
   the two modes' embeddings agree (cosine >= 0.999); one chunk with every
   kernel and with every plain version (``preprocess_ref``, the einsum
   tower and the plain prefill) gives embeddings with cosine >= 0.999 and
   first-token logits within ``VISION_LOGIT_TOL``, and the logits of a
   planted fault (the short-attention kernel without its ``1/sqrt(hd)``
   scale) are read beside them; ``kg`` -> ``batch-retrieve`` run on the
   written ``vlm_output.json`` as subprocesses, and the ViT and
   ``generate`` are timed;
12. the w8a16 kernel (``ops/q8_matmul.py``) against its plain version on
   the card: the eight (K, N) of the block matrices of
   ``CaptionerConfig.large()`` and ``base()`` x M in {1, 5, 8, 32, 64},
   plus a column of zeros (the scale's floor, 1e-8) and |x| up to 1e3:
   max |err| <= 1e-4 x max |plain|, and two runs equal bit for bit.  Then
   device times per call (``graph_ms``; every call of a replay reads
   another copy of the weights, 20 copies, so that the weights of
   ``large()`` come from device memory as they do in a decode) of the
   kernel, the plain version, the plain ``a16`` expression, and two
   yardsticks the port never calls: cuBLAS ``x_bf16 @ w_bf16`` and
   ``torch._weight_int8pack_mm`` (null where this torch does not run it);
13. quantised serving at full width: seed weights for ``ViTConfig.b32()``
   and ``CaptionerConfig.large()`` in bfloat16, written as a JAX-format
   npz and loaded by ``TPUVLMClient(checkpoint=..., param_dtype=bfloat16,
   quantize=...)``.  (i) ``quantize`` None, ``int8`` and ``int8_a8`` each
   caption two synthetic chunks; the int8 tree holds under 0.55 of the
   bf16 tree's bytes.  (ii) The int8 tree with ``qmode='a16p'`` through
   ``generate`` at B = 4 and 8, 64 new bytes, between a reset and a read
   of the counts: the kernel's launches equal 4 products x 24 layers x the
   decode steps, plus the prefill's when its B x 9 rows are at most 64,
   and the plain version serves nothing.  (iii) Teacher-forced ``forward``
   logits (one sequence a call, 40 rows): each int8 mode against bf16 by
   cosine, ``a16p`` against ``a16`` within ``Q8_LOGIT_TOL``, and a planted
   fault (the kernel without its scale) past it.  (iv) ms/step and
   tokens/s of the four modes at B = 8 and 32
   (``scripts/profile_torch_int8_decode.py::bench_decode``).  (v) The
   CLI's ``vlm`` with ``vlm.quantize: int8`` at ``base()`` width on phase
   11's frame source;
14. the FlashAttention backward kernels (``flash_bwd_delta``,
   ``flash_bwd_fused``, ``flash_bwd_dq_convert``: one pass, five products)
   and the forward's log-sum-exp
   against their plain versions (``attention_bwd_ref``, ``lse_ref``; one
   batch row at a time, so that the plain [h, T, T] tensors stay small) at
   the shapes the training paths launch: B 8 x T 3080 and B 16 x T 1544 at
   8 heads x 64 (``CaptionerConfig.chat()``, both buckets of the instruct
   trainer), B 16 x T 1032 at 16 x 64 (the mid-scale config), T 1033 at
   16 x 128, T 40 and 1033 with nv 0 and 8, and prefixes of 64, 70 and
   100 (T 64, 130, 200): dq, dk, dv within
   ``TOL_ABS + TOL_REL * |plain|`` and ``BWD_REL_FRO`` of the plain
   gradient's norm, two runs' dk and dv equal bit for bit and their float32
   dq accumulators within ``DQ_RUN_REL`` of its norm (atomics add in no
   fixed order), and a planted fault (the plain backward without
   ``delta``) outside the tolerance.  Then CUDA-event medians at the three
   training shapes: the forward with its residual, each backward kernel
   and the three together, the plain backward, and
   ``F.scaled_dot_product_attention`` forward + backward under autograd
   with the boolean prefix mask (the yardstick, never called by the port);
15. training at full width through the trainers' ``main``: (a)
   ``scripts/train_torch_instruct_lm.py`` at ``CaptionerConfig.chat()``
   width, ``--seq-len 3072 --batch 8 --flash``, 12 steps, on the golden
   vlm output plus synthetic captions with the dataset counts of
   ``--smoke``: between a reset and a read of the counts, the forward and
   both backward kernels launch once per layer per step (the forward also
   for the held-out evaluations and the eval's prefills) and the plain
   attention serves nothing; the held-out loss is finite and lower at the
   end; the first batch's loss and the gradient of every leaf with the
   kernels against the masked einsum with remat from the same weights
   (max |diff| / max |plain| < ``TRAIN_GRAD_TOL`` per leaf), and a planted
   fault (the attention output cut from the graph, as it was before the
   kernels had a backward) past it; the saved ``instruct_lm.npz`` then
   serves one completion through ``make_chat_client("tpu")``.  (b)
   ``scripts/train_torch_midscale.py --flash --steps 12`` at the 204M
   config (batch 16 x 1024), then 12 steps with the masked einsum and
   remat from the same seed (the same weights, batches and schedule): step
   time, tokens/s, MFU against 989 TFLOP/s, peak memory, the bf16 round
   trip; the two runs' first four losses within ``MIDSCALE_LOSS_TOL``, and
   every leaf's gradient at the mid-scale width (16 heads x 1024, a batch
   of 4 x 1024 windows) with the kernels against einsum + remat within
   ``TRAIN_GRAD_TOL``.  (c) ``models/train.py::TrainState`` at
   ``ViTConfig.b32()`` + ``CaptionerConfig.base()`` width, B 8, 3 steps on
   one batch: the loss falls;
16. ACS, the device sweep as torch ops (``pipeline/acs.py``, no kernel of
   its own): on ``bench.py``'s ``barabasi_albert_graph(926, 2, seed=0)``,
   ``update_metrics`` under ``acs.backend: auto`` takes the device sweep
   and returns no ``error``; every metric but Louvain's equals exact
   NetworkX (the port's ``networkx`` backend with sampling off) within
   ``tests/test_acs.py``'s tolerances, the others within
   ``ACS_OTHER_TOL``.  Then ms of a full metric pass (``_compute``, the
   mean of 3 after a warm-up) with the device sweep
   (``acs_full_metrics_ms_926n``, ``bench.py``'s key) and with the
   ``networkx`` backend as ``auto`` would run it, at 926 nodes and on
   Barabási–Albert graphs of 64, 96, 128, 256 and 512 nodes: where
   ``auto`` would switch on this card.

``--phases 14,15,16`` runs only the named phases (with the build): a
partial run prints no kernels record and no ``ok`` line.

The last three lines: the kernels' JSON record, the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.  Each
kernel's entry carries its launches on the main path, its max |error|
against its plain version, the times of the kernel, the plain version and
a library call (``library_ms``, or null; CUDA-event medians, and for the
two vision kernels the device's time per call from a CUDA graph of 20
calls, with ``call_ms`` the CUDA-event median of a call of the wrapper),
and ``bound_ms``: the larger of the bytes it must move over 3.35 TB/s and
its operations over the card's peak for their type (989 TFLOP/s bf16, 67
TFLOP/s float32).  Without a CUDA card, or outside a checkout, it exits nonzero and prints no result.
``tiktoken`` is kept out of every phase: its encoder would be fetched over
the network; without it the token splitter uses its calibrated estimator.

``python3 chip_smoke.py --cli COUNTS.json <command> [args]`` is the
subprocess side of phase 7: the port's CLI ``main`` with the launch counts
and chat-LM dispatches written to ``COUNTS.json`` at exit.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import itertools
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
STORE_ROWS, STORE_COUNT, DIM = 200_000, 199_937, 512
# phase 8: bf16 prefill logits with and without the kernel (8 layers of
# one-ulp differences in the attention output; logits of about unit scale)
LOGIT_TOL = 0.05
# phase 11: first-token logits with every kernel and with every plain
# version.  On an H100 80GB HBM3 (700 W) the two sides' embeddings agreed
# bit for bit and the logits (max |logit| 1.45) differed by 0.0078, the
# flash prefill's share; the planted fault (short attention without its
# 1/sqrt(hd) scale) moved them by 0.85.  The limit sits between the two,
# and the run fails if the planted fault does not exceed it.
VISION_LOGIT_TOL = 0.05
# phase 13: teacher-forced logits of the int8 tree at CaptionerConfig.
# large() width, 24 layers deep.  The kernel (a16p) rounds a product to
# bf16 once, the plain a16 expression twice: on an H100 80GB HBM3 (700 W)
# the two differed by 0.047 at a logit scale of 3.4, and the planted fault
# (the kernel without its scale) moved the logits by 3.2; the limit sits
# between, and the run fails if the fault does not exceed it.  The cosines
# against the bf16 tree read 0.99953 (a16), 0.99954 (a16p), 0.99916 (a8).
Q8_LOGIT_TOL = 0.1
Q8_COSINE_MIN = 0.998
# phase 13: the same bf16 logits with the flash kernel (16 heads of 128,
# T = 40) and with the plain attention, 24 layers deep: 0.031 apart at a
# logit scale of 3.4 on an H100 80GB HBM3 (700 W).
LARGE_FLASH_LOGIT_TOL = 0.1
# phase 14: ||kernel - plain||_F <= BWD_REL_FRO x ||plain||_F per gradient
# (the gradients of late rows are far below TOL_ABS, so the elementwise
# tolerance alone would pass much there)
BWD_REL_FRO = 2e-2
# phase 14: two runs' float32 dq accumulators (atomics add in no fixed
# order): ||a - b||_F <= DQ_RUN_REL x ||a||_F
DQ_RUN_REL = 1e-6
# phase 15: per-leaf gradients of the training loss with the kernels and
# with the masked einsum + remat, max |diff| / max |plain| (the limit of the
# JAX package's own flash-vs-einsum gradient test on its chip)
TRAIN_GRAD_TOL = 0.05
# phase 15b: |loss_flash - loss_einsum_remat| over the mid-scale runs' first
# four steps (same seed: same weights, batches and schedule).  The two
# differ by bf16 products in another order: the logits by bf16 rounding
# (~1e-4 on a step's loss), which Adam's first updates, near lr x sign(g),
# may carry into the next steps' weights.  0.01 stays far below what one
# update moves the loss (~0.8 at step 2), so a wrong gradient cannot pass
MIDSCALE_LOSS_TOL = 0.01
# phase 16: the metrics tests/test_acs.py does not name, device sweep vs
# exact NetworkX (both exact; rounded to 4 decimals)
ACS_OTHER_TOL = 1e-3
# H100 SXM peaks (NVIDIA's data sheet): memory, bf16 and float32 dense
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
_TIKTOKEN_BLOCK = ('raise ImportError("tiktoken is kept out of this run: its '
                   'encoder would be fetched over the network")\n')


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 2
def check_topk(tc, q, store, k, count) -> float:
    """Kernel top-k against the plain version; returns the max |error|."""
    vals, idx = tc.cosine_topk(q, store, k, count=count)
    torch.cuda.synchronize()
    rv, ri = tc.cosine_topk_ref(q, store, k + 1, count=count)
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    rv, ri = rv.cpu().numpy(), ri.cpu().numpy()
    err = float(np.abs(vals - rv[:, :k]).max())
    assert err <= TOL, f"B={q.shape[0]} k={k}: score error {err}"
    padded = np.concatenate([np.full((rv.shape[0], 1), np.inf), rv,
                             np.full((rv.shape[0], 1), -np.inf)], axis=1)
    for j in range(k):
        apart = ((padded[:, j] - padded[:, j + 1] > TOL)
                 & (padded[:, j + 1] - padded[:, j + 2] > TOL))
        assert (idx[apart, j] == ri[apart, j]).all(), \
            f"B={q.shape[0]} k={k}: index mismatch at rank {j}"
    masked = idx >= count
    assert not (vals[masked] > -1e29).any(), "a masked row scored above -1e29"
    return err


def phase_kernels(tc, seed: int, card: str) -> dict:
    from vidgraph_tpu_torch.core.profiling import cuda_ms

    rng = np.random.default_rng(seed)
    host = rng.normal(size=(STORE_ROWS, DIM)).astype(np.float32)
    host /= np.linalg.norm(host, axis=1, keepdims=True)
    store = torch.from_numpy(host).cuda()
    queries = torch.from_numpy(
        rng.normal(size=(30, DIM)).astype(np.float32)).cuda()
    topk_err = 0.0
    for b in (1, 16, 30):
        for k in (1, 5, 64):
            topk_err = max(topk_err, check_topk(tc, queries[:b], store, k,
                                                STORE_COUNT))
    check_topk(tc, queries[:4], store, 5, 3)        # k above the count
    check_topk(tc, queries[:4], store, 64, 100)     # count below one tile
    dense = tc.cosine_scores(queries[:16], store, count=STORE_COUNT)
    torch.cuda.synchronize()
    dense_ref = tc.cosine_scores_ref(queries[:16], store, count=STORE_COUNT)
    score_err = float((dense - dense_ref).abs().max())
    assert score_err <= TOL, f"dense score error {score_err}"
    log(f"phase 2: kernel agrees with the plain version: top-k max |err| "
        f"{topk_err:.3e}, dense max |err| {score_err:.3e}")

    times = {}
    for b in (1, 16):
        q = queries[:b]
        times[f"topk_b{b}_k5"] = {
            "kernel_ms": cuda_ms(
                lambda: tc.cosine_topk(q, store, 5, count=STORE_COUNT)),
            "plain_ms": cuda_ms(
                lambda: tc.cosine_topk_ref(q, store, 5, count=STORE_COUNT)),
            # context, not the plain version: an unordered-ties top-k
            "matmul_topk_ms": cuda_ms(lambda: torch.topk(
                tc.cosine_scores_ref(q, store, count=STORE_COUNT), 5)),
        }
    q = queries[:16]
    times["dense_b16"] = {
        "kernel_ms": cuda_ms(
            lambda: tc.cosine_scores(q, store, count=STORE_COUNT)),
        "plain_ms": cuda_ms(
            lambda: tc.cosine_scores_ref(q, store, count=STORE_COUNT)),
    }
    stages = time_topk_stages(tc, queries[:16], store)
    past = torch.arange(STORE_ROWS, device="cuda") >= STORE_COUNT
    library = {
        "topk_b1_k5": cuda_ms(lambda: library_topk(q[:1], store, past, 5)),
        "topk_b16_k5": cuda_ms(lambda: library_topk(q, store, past, 5)),
        "score_topk_b16_k5": cuda_ms(
            lambda: library_tile_topk(tc, q, store, past, 5)),
        "merge_b16_k5": cuda_ms(lambda: torch.topk(
            stages["partials"][0].view(16, -1), 5)),
        "dense_b16": cuda_ms(lambda: library_scores(q, store, past)),
    }
    pv, pi = stages.pop("partials")
    partial_bytes = pv.numel() * 4 + pi.numel() * 4
    log(f"phase 2 times on {card} (median of 20, ms) at 200,000 x 512 f32:",
        json.dumps(times), json.dumps(stages), "library:",
        json.dumps(library))
    return {"topk_err": topk_err, "score_err": score_err, "times": times,
            "stages": stages, "library": library,
            "partial_bytes": partial_bytes}


def library_scores(q, store, past):
    """The library yardstick of the dense mode: ``F.normalize`` and one
    matrix product, the rows ``past`` the count masked."""
    scores = F.normalize(q, dim=-1) @ store.T
    return scores.masked_fill_(past, -1e30)


def library_topk(q, store, past, k):
    """The library yardstick of the top-k: ``torch.topk`` over the
    masked cosine scores."""
    return torch.topk(library_scores(q, store, past), k)


def library_tile_topk(tc, q, store, past, k):
    """The yardstick of the score kernel's top-k mode: the masked
    scores, padded to whole tiles, and ``torch.topk`` within each tile."""
    tile = tc._build.library().cosine_tile_rows()
    n = store.shape[0]
    pad = -n % tile
    scores = F.pad(library_scores(q, store, past), (0, pad),
                   value=float("-inf"))
    return torch.topk(scores.view(q.shape[0], -1, tile), k, dim=-1)


def bound(nbytes: float, ops: float, peak: float) -> dict:
    """The least time the card could take: the larger of ``nbytes`` over
    the memory rate and ``ops`` over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BPS, ops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_topk_stages(tc, q, store, k: int = 5) -> dict:
    """Each kernel of the top-k apart, at B=16, k=5: ``cosine_score_tile``
    in top-k mode (per-tile partials) and ``cosine_topk_merge``, each
    checked against its own plain version on the same inputs."""
    from vidgraph_tpu_torch.core.profiling import cuda_ms

    tile = tc._build.library().cosine_tile_rows()
    pv, pi = tc.topk_partials(q, store, k, STORE_COUNT)
    torch.cuda.synchronize()
    rv, _ = tc.topk_partials_ref(q, store, k, STORE_COUNT, tile)
    assert torch.equal(pv.isinf(), rv.isinf()), "partials past the store"
    finite = ~rv.isinf()
    partial_err = float((pv[finite] - rv[finite]).abs().max())
    assert partial_err <= TOL, f"top-k partials error {partial_err}"
    vals, idx = tc.topk_merge(pv, pi, k)
    torch.cuda.synchronize()
    mv, mi = tc.topk_merge_ref(pv, pi, k)
    merge_err = float((vals - mv).abs().max())
    assert merge_err == 0 and torch.equal(idx, mi), "merge disagrees"
    return {
        "partials": (pv, pi),
        "score_topk_b16_k5": {
            "kernel_ms": cuda_ms(
                lambda: tc.topk_partials(q, store, k, STORE_COUNT)),
            "plain_ms": cuda_ms(
                lambda: tc.topk_partials_ref(q, store, k, STORE_COUNT, tile)),
            "max_abs_err": partial_err},
        "merge_b16_k5": {
            "kernel_ms": cuda_ms(lambda: tc.topk_merge(pv, pi, k)),
            "plain_ms": cuda_ms(lambda: tc.topk_merge_ref(pv, pi, k)),
            "max_abs_err": merge_err},
    }


# ---------------------------------------------------------------- phases 3-4
def build_kg(device: str, recall: bool):
    """``kg`` in-process on ``device`` from the golden vlm output, with the
    golden recipe's settings or with ``config/high_recall_config.yaml``,
    whose pre-injector scores each batch against the chunk memory."""
    from vidgraph_tpu_torch.core.config import PipelineConfig
    from vidgraph_tpu_torch.graph import open_graph_store
    from vidgraph_tpu_torch.pipeline.kg_builder import KGBuilder

    os.environ["VIDGRAPH_TORCH_DEVICE"] = device
    vlm_path = ROOT / "tests/golden/vlm_output_golden.json"
    with tempfile.TemporaryDirectory() as tmp:
        old = os.getcwd()
        os.chdir(tmp)
        try:
            if recall:
                cfg = PipelineConfig.from_yaml(
                    str(ROOT / "config/high_recall_config.yaml"))
                cfg.acs.backend = "networkx"
            else:
                cfg = PipelineConfig()
                cfg.backend.llm = "local"
                cfg.kg.batch_size = 2
            cfg.graph_store.persist_dir = "gs"
            asyncio.run(KGBuilder(cfg, run_uuid="golden")
                        .build_knowledge_graph(str(vlm_path)))
            store = open_graph_store(cfg, "golden")
        finally:
            os.chdir(old)
    assert store._chunk_emb.device.type == device
    return store


def graph_of(store) -> tuple:
    return (sorted(store.entities), sorted("|".join(k) for k in store.rels),
            sorted(store.chunks), store.get_chunk_counts())


def phase_golden(device: str = "cuda") -> None:
    golden = json.loads((ROOT / "tests/golden/pipeline_golden.json")
                        .read_text())
    store = build_kg(device, recall=False)
    assert graph_of(store) == (golden["entities"], golden["rels"],
                               golden["chunk_ids"], golden["chunk_counts"])
    assert [e["name"] for e in store.fulltext_search_entities(
        "red shape object", 3)] == golden["fulltext_top"]
    log("phase 3: golden rebuild on the card matches "
        "tests/golden/pipeline_golden.json")


def bench_retriever(device: str):
    """bench.py's reference-scale graph on ``device``, behind a hybrid
    retriever set as ``bench.py:93-95`` sets it, and its 30 queries."""
    import bench
    from vidgraph_tpu_torch.core.config import PipelineConfig
    from vidgraph_tpu_torch.graph.embedded import EmbeddedGraphStore
    from vidgraph_tpu_torch.pipeline.retriever_hybrid import HybridRetriever
    from vidgraph_tpu_torch.services.embed_client import make_embed_client
    from vidgraph_tpu_torch.services.rerank_client import make_rerank_client

    os.environ["VIDGRAPH_TORCH_DEVICE"] = device
    rng = random.Random(42)
    cfg = PipelineConfig()
    cfg.retrieval.entity_first = False
    cfg.retrieval.post_compression = True
    cfg.retrieval.rerank_after_traversal = True
    embedder = make_embed_client("tpu", dim=cfg.embedding_memory.dim)
    reranker = make_rerank_client("tpu", embed_client=embedder)
    store = EmbeddedGraphStore("bench", persist_dir=None, persist=False)
    bench._build_graph(store, embedder, rng)
    assert store._chunk_emb.device.type == device
    retriever = HybridRetriever(cfg.retrieval, store, embedder, reranker,
                                output_file=None)
    queries = [f"What color is the {rng.choice(bench._OBJECTS)} "
               f"{rng.choice(['on the bench', 'in the lab', 'nearby'])}?"
               for _ in range(bench.N_QUERIES)]
    return retriever, store, queries


def bench_retrieval(device: str) -> dict:
    """The 30 queries after 5 warm-up queries, timed one by one."""
    import bench

    retriever, store, queries = bench_retriever(device)

    async def run_all():
        for q in queries[:bench.WARMUP]:
            await retriever.perform_hybrid_retrieval(q)
        texts, times = [], []
        for q in queries:
            t = time.perf_counter()
            text, _ = await retriever.perform_hybrid_retrieval(q)
            times.append((time.perf_counter() - t) * 1e3)
            texts.append(text)
        return texts, times

    texts, times = asyncio.run(run_all())
    times.sort()
    return {"texts": texts, "p50_ms": statistics.median(times),
            "p95_ms": times[int(0.95 * (len(times) - 1))],
            "entities": len(store.entities), "chunks": len(store.chunks),
            "rels": len(store.rels)}


def store_search_ms(seed: int) -> dict:
    """Top-5 search of the port's EmbeddingStore at the bench's 200k rows,
    host clock around calls that end with the results on the host."""
    from vidgraph_tpu_torch.memory.embedding_store import EmbeddingStore

    rng = np.random.default_rng(seed + 1)
    store = EmbeddingStore(dim=DIM, capacity=STORE_ROWS)
    step = 20_000
    for i in range(0, STORE_ROWS, step):
        store.add([f"c{j}" for j in range(i, i + step)],
                  rng.normal(size=(step, DIM)).astype(np.float32))
    q = rng.normal(size=(16, DIM)).astype(np.float32)
    out = {}
    for b in (1, 16):
        store.search(q[:b], k=5)
        times = []
        for _ in range(20):
            t = time.perf_counter()
            hits = store.search(q[:b], k=5)
            times.append((time.perf_counter() - t) * 1e3)
        assert len(hits) == b and all(len(h) == 5 for h in hits)
        out[f"b{b}_ms"] = statistics.median(times)
    return out


def launch_counts(tc) -> dict:
    return {**tc.LAUNCHES, "plain": tc.REF_CALLS}


def phase_main_path(tc, seed: int) -> dict:
    """The main path on the card, ``kg`` and then retrieval, between a
    reset and a read of the launch counts; the store timing and the CPU
    reference run only after the read."""
    import bench

    tc.reset_counts()
    phase_golden("cuda")
    recall_graph = graph_of(build_kg("cuda", recall=True))
    kg = launch_counts(tc)
    cuda = bench_retrieval("cuda")
    total = launch_counts(tc)
    retrieval = {key: total[key] - kg[key] for key in total}
    log(f"phase 3-4: launches in kg {kg}, in retrieval {retrieval}")
    assert kg["score_dense"] > 0, f"kg launched no dense scoring: {kg}"
    n_searches = bench.WARMUP + bench.N_QUERIES
    assert min(retrieval["score_topk"], retrieval["merge"]) >= n_searches, \
        f"{n_searches} queries but launches {retrieval}"
    assert total["plain"] == 0, f"the plain version served {total}"
    assert all(cuda["texts"]), "an empty retrieval text"

    store_ms = store_search_ms(seed)
    log(f"phase 4: bench-scale retrieval on the card: "
        f"{cuda['entities']} entities, {cuda['chunks']} chunks, "
        f"{cuda['rels']} relations; p50 {cuda['p50_ms']:.3f} ms, "
        f"p95 {cuda['p95_ms']:.3f} ms; 200k-row store top-5 search "
        f"{json.dumps(store_ms)}")
    assert graph_of(build_kg("cpu", recall=True)) == recall_graph, \
        "the recall-config graph differs from the CPU build"
    log(f"phase 3: recall-config kg on the card: {len(recall_graph[0])} "
        f"entities, {len(recall_graph[1])} relations, "
        f"{len(recall_graph[2])} chunks, equal to the CPU build")
    cpu = bench_retrieval("cpu")
    os.environ["VIDGRAPH_TORCH_DEVICE"] = "cuda"
    same = sum(a == b for a, b in zip(cuda["texts"], cpu["texts"]))
    assert same == len(cpu["texts"]), \
        f"{len(cpu['texts']) - same} retrieval texts differ from the CPU run"
    log(f"phase 4: all {same} retrieval texts equal the CPU run's")
    return {"launches": total, "p50_ms": cuda["p50_ms"],
            "p95_ms": cuda["p95_ms"], "store_ms": store_ms}


# ------------------------------------------------------------------ phase 5
def phase_cli(device: str = "cuda") -> None:
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "block").mkdir()
        (tmp / "block" / "tiktoken.py").write_text(_TIKTOKEN_BLOCK)
        cfg = tmp / "cfg.yaml"
        cfg.write_text((ROOT / "config/high_recall_config.yaml").read_text()
                       + "\nacs:\n  backend: networkx\n")
        queries = tmp / "queries.json"
        queries.write_text(json.dumps([
            {"query": "What color is the object?", "groundtruth": "red"},
            {"query": "What do the frames contain?",
             "groundtruth": "a static scene"}]))
        env = {**os.environ, "VIDGRAPH_TORCH_DEVICE": device,
               "PYTHONPATH": os.pathsep.join(
                   [str(tmp / "block"), str(ROOT),
                    os.environ.get("PYTHONPATH", "")])}

        def cli(*args) -> str:
            res = subprocess.run(
                [sys.executable, "-m", "vidgraph_tpu_torch.cli.main", *args],
                cwd=tmp, env=env, capture_output=True, text=True,
                timeout=300)
            assert res.returncode == 0, \
                f"{args[0]} exited {res.returncode}:\n{res.stderr[-3000:]}"
            return res.stdout

        out = cli("kg", "--config", str(cfg), "--vlm-output",
                  str(ROOT / "tests/golden/vlm_output_golden.json"))
        uuid = out.strip().rsplit("UUID: ", 1)[1]
        cli("batch-retrieve", "--config", str(cfg), "--graph-uuid", uuid,
            "--input", str(queries), "--output", "results.json")
        cli("benchmark", "--config", str(cfg), "--input", "results.json",
            "--output", "bench.json")
        results = json.loads((tmp / "results.json").read_text())
        assert len(results) == 2 and all(
            {"query", "groundtruth", "retrieval", "retrieval_time"}
            <= set(r) and r["retrieval"] for r in results), results
        stats = json.loads((tmp / "bench.json").read_text())
        assert set(stats) == {"statistics", "results"}
        assert stats["statistics"]["total_queries"] == 2
        log(f"phase 5: CLI kg -> batch-retrieve -> benchmark on the card: "
            f"uuid {uuid}, statistics {json.dumps(stats['statistics'])}")


# ------------------------------------------------------------------ phase 6
# (B, T, heads, head dim): the chat LM's and base()'s 8 x 64, then the 16 x
# 128 of CaptionerConfig.large() at the shapes phase 13 gives the kernel
# (generate's prefill of nv + BOS = 9 at B 4/8/32, sequence_logits' T = 40)
# and one long T.
FLASH_SHAPES = [(1, 2056, 8, 64), (8, 2056, 8, 64), (32, 2056, 8, 64),
                (4, 1033, 8, 64), (4, 40, 8, 64),
                (4, 9, 16, 128), (8, 9, 16, 128), (32, 9, 16, 128),
                (1, 40, 16, 128), (1, 2056, 16, 128)]


def phase_flash(seed: int, card: str) -> dict:
    """The flash kernel against ``attention_ref`` at the serving shapes,
    then CUDA-event medians of both at T = 2056."""
    from vidgraph_tpu_torch.core.profiling import cuda_ms
    from vidgraph_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(seed + 2)
    rows = {}
    for b, t, h, hd in FLASH_SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, t, h, hd), dtype=np.float32)).to("cuda", torch.bfloat16)
            for _ in range(3))
        got = fa.flash_attention(q, k, v, 8)
        torch.cuda.synchronize()
        ref = fa.attention_ref(q, k, v, 8).to(torch.bfloat16).float()
        err = (got.float() - ref).abs()
        excess = float((err - fa.TOL_ABS - fa.TOL_REL * ref.abs()).max())
        assert bool(torch.isfinite(got).all()) and excess <= 0, \
            f"flash b={b} T={t} heads {h} x {hd}: max |err| " \
            f"{float(err.max())} over tolerance"
        row = {"max_abs_err": float(err.max())}
        del got, ref, err
        if t == 2056:
            row["kernel_ms"] = cuda_ms(
                lambda: fa.flash_attention(q, k, v, 8))
            row["plain_ms"] = cuda_ms(
                lambda: fa.attention_ref(q, k, v, 8), reps=5 if b > 8 else 20)
            row.update(library_sdpa(q, k, v, fa.prefix_causal_mask(
                t, 8, q.device)))
        rows[f"b{b}_T{t}" + ("" if hd == 64 else f"_h{h}x{hd}")] = row
        del q, k, v
        torch.cuda.empty_cache()
    log(f"phase 6: flash kernel within {fa.TOL_ABS} + {fa.TOL_REL} x |plain| "
        f"of the plain version at 8 heads x 64 and 16 x 128 (keys "
        f"_h16x128), bf16, nv 8; times on {card} (median, ms): "
        f"{json.dumps(rows)}")
    return rows


def device_kernels(fn) -> list:
    """The names of the device kernels that ``fn()`` runs (three calls
    traced): which backend served a library call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    return sorted({e.name[:80] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def library_sdpa(q, k, v, mask) -> dict:
    """``F.scaled_dot_product_attention`` on [B, T, h, hd] inputs (as
    [B, h, T, hd] views) with a boolean mask: its median time, the
    backends that accept the call, and the device kernels that PyTorch's
    default choice ran."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vidgraph_tpu_torch.core.profiling import cuda_ms

    qh, kh, vh = (z.transpose(1, 2) for z in (q, k, v))
    accepted = []
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
            torch.cuda.synchronize()
            accepted.append(backend.name)
        except RuntimeError:
            pass
    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    return {"library_ms": cuda_ms(sdpa, reps=10),
            "library_backends": accepted,
            "library_kernels": device_kernels(sdpa)}


# ------------------------------------------------------------------ phase 7
def cli_with_counts(counts_path: str, argv) -> int:
    """Subprocess side of phase 7: the port's CLI, then its launch counts
    into ``counts_path``."""
    from vidgraph_tpu_torch.cli.main import main as cli_main
    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.ops import topk_cosine as tc

    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    Path(counts_path).write_text(json.dumps({
        "rc": rc, "seconds": time.perf_counter() - t0,
        "flash": fa.LAUNCHES["flash_fwd"], "flash_plain": fa.REF_CALLS,
        "topk": {**tc.LAUNCHES, "plain": tc.REF_CALLS}}))
    return rc


_DISPATCH_LOG = re.compile(r"decode dispatch b=(\d+)\(pad (\d+)\) "
                           r"t_pad=(\d+) max_new=(\d+): ([\d.]+)s")


def dispatches(stderr: str) -> list:
    """(b, b_pad, t_pad, max_new, seconds) of each chat-LM dispatch that
    ``TPUChatClient`` logged."""
    return [(*map(int, m.groups()[:4]), float(m.group(5)))
            for m in _DISPATCH_LOG.finditer(stderr)]


def chat_config(tmp: Path, name: str, checkpoint: Path) -> Path:
    """``config/<name>`` with the chat LM's checkpoint and the graph store
    pointed into ``tmp``; nothing else changed."""
    import yaml

    data = yaml.safe_load((ROOT / "config" / name).read_text())
    data["llm_injector"]["checkpoint_path"] = str(checkpoint)
    data["graph_store"]["persist_dir"] = str(tmp / "graph_store")
    out = tmp / f"{checkpoint.stem}_{name}"
    out.write_text(yaml.safe_dump(data))
    return out


# The byte chain of ``plant_bigram``: ``view| dark| dark`` lines, words of
# the golden captions, so that the refiner's grounding guard keeps them.
_PLANTED = {"\n": "v", "v": "i", "i": "e", "e": "w", "w": "|", "|": " ",
            " ": "d", "d": "a", "a": "r", "r": "k", "k": "|"}


def plant_bigram(params: dict) -> dict:
    """Seed weights with a byte bigram planted, so that extraction writes
    a parseable, grounded triplet after a prompt's final newline and
    ``kg`` reaches refinement: each byte of ``_PLANTED`` gets a large
    zero-mean embedding direction of its own, and the head maps it to the
    byte's successor (``k``: ``|``, or a newline where the grammar forbids
    ``|``).  Everything else stays random."""
    tok, head = params["tok_emb"].clone(), params["head_w"].clone()
    for i, (byte, nxt) in enumerate(_PLANTED.items()):
        u = torch.zeros(head.shape[0])
        u[2 * i], u[2 * i + 1] = 1.0, -1.0
        tok[ord(byte)] = 30.0 * u
        head[:, ord(nxt)] += 2.0 * u
    head[:, ord("\n")] += tok[ord("k")] / 30.0
    return {**params, "tok_emb": tok, "head_w": head}


def check_flash_path(stage: str, runs, layers: int) -> dict:
    """Flash launches >= layers x dispatches, and no plain-version call,
    over the subprocess runs of one stage."""
    n = sum(len(r["dispatches"]) for r in runs)
    flash = sum(r["flash"] for r in runs)
    plain = sum(r["flash_plain"] for r in runs)
    log(f"phase 7: {stage}: {n} chat-LM dispatches, flash launches {flash}, "
        f"plain-version calls {plain}; top-k launches "
        f"{[r['topk'] for r in runs]}")
    assert n > 0, f"{stage} made no chat-LM dispatch"
    assert flash >= layers * n, f"{stage}: {flash} flash launches for {n} " \
        f"dispatches of {layers} layers"
    assert plain == 0, f"{stage}: the plain attention served {plain} calls"
    return {"dispatches": n, "flash": flash, "plain": plain}


def phase_chat_lm(seed: int) -> dict:
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     init_params)
    from vidgraph_tpu_torch.models.checkpoint import save_params

    cfg = CaptionerConfig.chat()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "block").mkdir()
        (tmp / "block" / "tiktoken.py").write_text(_TIKTOKEN_BLOCK)
        ckpt, planted = tmp / "instruct_lm.npz", tmp / "planted_lm.npz"
        params = init_params(cfg, torch.Generator().manual_seed(seed))
        save_params(params, str(ckpt))
        save_params(plant_bigram(params), str(planted))
        llm_cfg = chat_config(tmp, "tpu_llm_config.yaml", ckpt)
        planted_cfg = chat_config(tmp, "tpu_llm_config.yaml", planted)
        judge_cfg = chat_config(tmp, "judge_tpu_config.yaml", ckpt)
        (tmp / "queries.json").write_text(json.dumps([
            {"query": "What color is the object?", "groundtruth": "red"},
            {"query": "What do the frames contain?",
             "groundtruth": "a static scene"}]))
        env = {**os.environ, "VIDGRAPH_TORCH_DEVICE": "cuda",
               "PYTHONPATH": os.pathsep.join(
                   [str(tmp / "block"), str(ROOT),
                    os.environ.get("PYTHONPATH", "")])}
        env.pop("VIDGRAPH_NO_FLASH_PREFILL", None)

        def cli(*args) -> dict:
            counts = tmp / f"counts_{len(list(tmp.glob('counts_*')))}.json"
            res = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--cli",
                 str(counts), *args], cwd=tmp, env=env,
                capture_output=True, text=True, timeout=600)
            assert res.returncode == 0, \
                f"{args[0]} exited {res.returncode}:\n{res.stderr[-3000:]}"
            return {**json.loads(counts.read_text()), "stdout": res.stdout,
                    "stderr": res.stderr,
                    "dispatches": dispatches(res.stderr)}

        kg, kg_planted = (
            cli("kg", "--config", str(c), "--vlm-output",
                str(ROOT / "tests/golden/vlm_output_golden.json"))
            for c in (llm_cfg, planted_cfg))
        kg_check = check_flash_path("kg (seed, planted)", [kg, kg_planted],
                                    cfg.layers)
        assert any(d[3] == 768 for d in kg_planted["dispatches"]), \
            "the planted kg made no refinement dispatch"
        uuid = kg["stdout"].strip().rsplit("UUID: ", 1)[1]
        retrieve = cli("batch-retrieve", "--config", str(llm_cfg),
                       "--graph-uuid", uuid, "--input", "queries.json",
                       "--output", "results.json")
        bench = cli("benchmark", "--config", str(llm_cfg), "--input",
                    "results.json", "--output", "bench.json")
        judged = cli("benchmark", "--config", str(judge_cfg), "--input",
                     "results.json", "--output", "bench_judge.json")
        bench_check = check_flash_path("benchmark (chat-LM answers, chat-LM "
                                       "judge)", [bench, judged], cfg.layers)
        for name in ("bench.json", "bench_judge.json"):
            stats = json.loads((tmp / name).read_text())
            assert stats["statistics"]["total_queries"] == 2, stats
        graphs = {}
        for name, run in (("seed", kg), ("planted", kg_planted)):
            snap = json.loads((tmp / "graph_store" / "{}.json".format(
                run["stdout"].strip().rsplit("UUID: ", 1)[1])).read_text())
            graphs[name] = {"entities": len(snap["entities"]),
                            "relations": len(snap["rels"])}
        assert graphs["planted"]["relations"] > 0, graphs
        n_batches = kg["stderr"].count(" injected in ")
        assert n_batches > 0, "kg injected no batch"
        runs = {"kg": kg, "kg (planted)": kg_planted,
                "batch-retrieve": retrieve, "benchmark": bench,
                "benchmark (judge tpu)": judged}
    by_shape: dict = {}
    for run in runs.values():
        for _b, b_pad, t_pad, max_new, secs in run["dispatches"]:
            by_shape.setdefault(f"b_pad {b_pad}, t_pad {t_pad}, max_new "
                                f"{max_new}", []).append(secs)
    per_dispatch = {k: {"n": len(v), "mean_s": statistics.mean(v)}
                    for k, v in sorted(by_shape.items())}
    out = {"kg": kg_check, "benchmark": bench_check,
           "kg_s": kg["seconds"], "kg_batches": n_batches,
           "kg_s_per_batch": kg["seconds"] / n_batches,
           "kg_planted_s": kg_planted["seconds"], "graphs": graphs,
           "s_per_dispatch": per_dispatch,
           "wall_s": {k: r["seconds"] for k, r in runs.items()}}
    log(f"phase 7: backend.llm tpu at CaptionerConfig.chat() width: kg "
        f"{out['kg_s']:.2f} s for {n_batches} batches "
        f"({out['kg_s_per_batch']:.2f} s/batch), planted kg "
        f"{out['kg_planted_s']:.2f} s; graphs {json.dumps(graphs)}; "
        f"s/dispatch "
        f"{json.dumps(per_dispatch)}; CLI wall s {json.dumps(out['wall_s'])}")
    return out


# ------------------------------------------------------------------ phase 8
def phase_prefill_logits(seed: int) -> dict:
    """One b_pad 8 dispatch's prefill at full width, with the kernel and
    with the plain version, from the same seed-initialised weights."""
    from vidgraph_tpu_torch.models import tokenizer
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     init_params,
                                                     prefill_logits)

    cfg = CaptionerConfig.chat()
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device=torch.device("cuda"))
    golden = json.loads((ROOT / "tests/golden/vlm_output_golden.json")
                        .read_text())["results"]
    prompts = [f"TEXT TO ANALYSE:\n{it['content'] * (1 + 3 * i)}\n\n"
               f"TRIPLET LINES:\n" for i, it in enumerate(golden * 2)]
    t_pad = 2048
    toks = np.full((len(prompts), t_pad), tokenizer.PAD_ID, np.int32)
    last = []
    for r, p in enumerate(prompts):
        ids = tokenizer.encode(p, add_bos=True, add_eos=False)[:t_pad]
        toks[r, :len(ids)] = ids
        last.append(cfg.num_vision_tokens + len(ids) - 1)
    toks = torch.from_numpy(toks).cuda()
    with torch.no_grad():
        flash, _ = prefill_logits(params, cfg, toks, 512, flash=True)
        plain, _ = prefill_logits(params, cfg, toks, 512, flash=False)
    torch.cuda.synchronize()
    err = float((flash - plain).abs().max())
    assert bool(torch.isfinite(flash).all()) and err <= LOGIT_TOL, \
        f"prefill logits differ by {err} > {LOGIT_TOL}"
    rows = torch.arange(len(prompts), device="cuda")
    at = torch.tensor(last, device="cuda")
    lf, lp = flash[rows, at], plain[rows, at]
    top2 = torch.topk(lp, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
    same = lf.argmax(-1) == lp.argmax(-1)
    assert bool(same[decided].all()), "a first token differs where the " \
        "top-2 margin exceeds the tolerance"
    out = {"max_abs_err": err, "tol": LOGIT_TOL,
           "first_tokens_equal": int(same.sum()),
           "decided_rows": int(decided.sum()), "rows": len(prompts),
           "logit_scale": float(plain.abs().max())}
    log(f"phase 8: prefill logits with and without the kernel, b_pad 8 x "
        f"t_pad {t_pad} at full width: {json.dumps(out)}")
    return out


# ------------------------------------------------------------------ phase 9
PRE_SHAPES = [(5, 405, 720, True), (5, 405, 720, False),
              (160, 405, 720, True), (160, 405, 720, False),
              (5, 224, 224, True), (5, 120, 160, True)]


def library_resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """The preprocessing's library yardstick, never called by the port:
    ``F.interpolate(bilinear, antialias=True)`` and the CLIP affine."""
    from vidgraph_tpu_torch.ops.preprocess import _mean_std_255

    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(size, size),
                      mode="bilinear", antialias=True, align_corners=False)
    mean, std = _mean_std_255(x.device)
    return (y.permute(0, 2, 3, 1) - mean) / std


def phase_preprocess(seed: int, card: str) -> dict:
    """Kernel A against its plain version at the serving shapes, then
    medians of the kernel, the plain version, the library yardstick and
    the upload of the uint8 frames from (pageable) host memory."""
    from vidgraph_tpu_torch.core.profiling import cuda_ms, graph_ms
    from vidgraph_tpu_torch.ops import preprocess as pre

    rng = np.random.default_rng(seed + 3)
    rows = {}
    for b, h, w, fast in PRE_SHAPES:
        host = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
        x = torch.from_numpy(host).cuda()
        got = pre.preprocess_frames(x, 224, fast)
        torch.cuda.synchronize()
        ref = pre.preprocess_ref(x, 224, fast)
        tol = pre.TOL_FAST if ref.dtype == torch.bfloat16 else pre.TOL_F32
        err = float((got.float() - ref.float()).abs().max())
        assert got.dtype == ref.dtype and got.shape == ref.shape, got.shape
        assert bool(torch.isfinite(got).all()) and err <= tol, \
            f"preprocess {b}x{h}x{w} fast={fast}: max |err| {err} > {tol}"
        lib_err = float((library_resize(x, 224)
                         - pre.preprocess_ref(x, 224, False)).abs().max())
        out_bytes = b * 224 * 224 * 3 * got.element_size()

        def kernel():
            return pre.preprocess_frames(x, 224, fast)
        rows[f"b{b}_{h}x{w}_{'fast' if fast else 'exact'}"] = {
            "max_abs_err": err, "tol": tol,
            "kernel_ms": graph_ms(kernel),
            "plain_ms": graph_ms(lambda: pre.preprocess_ref(x, 224, fast)),
            "library_ms": graph_ms(lambda: library_resize(x, 224)),
            "call_ms": cuda_ms(kernel),
            "library_max_abs_diff_vs_exact": lib_err,
            "upload_ms": cuda_ms(lambda: torch.from_numpy(host).cuda()),
            **bound(host.nbytes + out_bytes, 0.0, F32_FLOPS)}
        del x, got, ref
    log(f"phase 9: preprocessing kernel within its tolerances of the plain "
        f"version; times on {card} (ms; device time per call, 20 calls "
        f"replayed from a CUDA graph; call_ms and upload_ms CUDA-event "
        f"medians): {json.dumps(rows)}")
    return rows


# ----------------------------------------------------------------- phase 10
def phase_short_attention(seed: int, card: str) -> dict:
    """Kernel B against its plain version at the ViT's shapes (separate
    tensors, and strided views of one qkv product as ``models/vit.py``
    passes them), then device times of the kernel, the plain version and
    SDPA."""
    from vidgraph_tpu_torch.core.profiling import cuda_ms, graph_ms
    from vidgraph_tpu_torch.ops import short_attention as sa

    rng = np.random.default_rng(seed + 4)
    rows = {}
    for name, b, strided in (("b1", 1, False), ("b5", 5, False),
                             ("b160", 160, False), ("b5_strided", 5, True),
                             ("b160_strided", 160, True)):
        if strided:
            qkv = torch.from_numpy(rng.standard_normal(
                (b, 50, 3 * 768), dtype=np.float32)).to("cuda",
                                                       torch.bfloat16)
            q, k, v = (z.reshape(b, 50, 12, 64).transpose(1, 2)
                       for z in qkv.split(768, dim=-1))
        else:
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (b, 12, 50, 64), dtype=np.float32)).to("cuda",
                                                       torch.bfloat16)
                for _ in range(3))
        got = sa.fused_short_attention(q, k, v)
        torch.cuda.synchronize()
        ref = sa.short_attention_ref(q, k, v).float()
        err = (got.float() - ref).abs()
        excess = float((err - sa.TOL_ABS - sa.TOL_REL * ref.abs()).max())
        assert bool(torch.isfinite(got).all()) and excess <= 0, \
            f"short attention {name}: max |err| {float(err.max())}"

        def kernel():
            return sa.fused_short_attention(q, k, v)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v)
        rows[name] = {
            "max_abs_err": float(err.max()),
            "kernel_ms": graph_ms(kernel),
            "plain_ms": graph_ms(lambda: sa.short_attention_ref(q, k, v)),
            "library_ms": graph_ms(sdpa),
            "library_kernels": device_kernels(sdpa),
            "call_ms": cuda_ms(kernel),
            **bound(4 * b * 12 * 50 * 64 * 2, 4.0 * b * 12 * 50 * 50 * 64,
                    BF16_FLOPS)}
    log(f"phase 10: short-attention kernel within {sa.TOL_ABS} + "
        f"{sa.TOL_REL} x |plain|; times on {card} (ms; device time per call, 20 "
        f"calls replayed from a CUDA graph; call_ms a CUDA-event median), 12 heads x N 50 x hd "
        f"64, bf16: {json.dumps(rows)}")
    return rows


# ----------------------------------------------------------------- phase 11
VISION_CHUNKS, VISION_FRAMES, VISION_HW = 6, 5, (405, 720)
_SCENES = ["red", "green", "blue", "yellow", "magenta", "cyan"]


def synthetic_chunks(n_chunks: int, frames_per_chunk: int,
                     chunk_seconds: float, fps: int = 10):
    """(chunk_idx, time label, [RGB uint8 frames]) as ``iter_chunk_frames``
    yields them, for a video that ``write_synthetic_video`` would write
    with one scene a chunk: a background of 30, a square of the scene's
    colour moving along a sine, at 405 x 720."""
    from vidgraph_tpu_torch.io.video import _COLORS, format_chunk_time

    h, w = VISION_HW
    side = min(h, w) // 2
    offsets = np.linspace(0, int(fps * chunk_seconds) - 1,
                          frames_per_chunk).astype(int)
    for idx in range(n_chunks):
        rgb = _COLORS[_SCENES[idx % len(_SCENES)]]
        frames = []
        for i in offsets:
            frame = np.full((h, w, 3), 30, np.uint8)
            x = int((w - side) * (0.5 + 0.4 * np.sin(i / 5.0)))
            y = (h - side) // 2
            frame[y:y + side, x:x + side] = rgb
            frames.append(frame)
        yield idx, format_chunk_time(idx, chunk_seconds), frames


def vision_counts() -> dict:
    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.ops import preprocess as pre
    from vidgraph_tpu_torch.ops import short_attention as sa

    return {"preprocess": pre.LAUNCHES["preprocess"],
            "short_attention": sa.LAUNCHES["short_attention"],
            "flash": fa.LAUNCHES["flash_fwd"],
            "plain": pre.REF_CALLS + sa.REF_CALLS + fa.REF_CALLS}


def reset_vision_counts() -> None:
    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.ops import preprocess as pre
    from vidgraph_tpu_torch.ops import short_attention as sa

    for mod in (pre, sa, fa):
        mod.reset_counts()


def extract(cfg, client, out: Path) -> dict:
    """``VLMExtractor.process_video`` between a reset and a read of the
    launch counts; returns the counts, the wall time and the output."""
    from vidgraph_tpu_torch.pipeline.vlm_extractor import VLMExtractor

    reset_vision_counts()
    t0 = time.perf_counter()
    asyncio.run(VLMExtractor(cfg, vlm_client=client).process_video(
        "synthetic_405x720.mp4", str(out)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = vision_counts()
    data = json.loads(out.read_text())
    assert set(data) == {"metadata", "results"}, set(data)
    assert set(data["metadata"]) == {"run_id", "video_path", "total_chunks",
                                     "config"}, data["metadata"]
    results = data["results"]
    assert data["metadata"]["total_chunks"] == len(results) == VISION_CHUNKS
    for i, r in enumerate(results):
        assert set(r) == {"time", "content", "chunk_idx", "processing_time"}
        assert r["chunk_idx"] == i and isinstance(r["content"], str)
    return {"counts": counts, "wall_s": wall, "results": results}


def vision_cli(vlm_output: Path, tmp: Path) -> dict:
    """``kg`` -> ``batch-retrieve`` on the written vlm output, as
    subprocesses with ``config/high_recall_config.yaml``."""
    (tmp / "block").mkdir(exist_ok=True)
    (tmp / "block" / "tiktoken.py").write_text(_TIKTOKEN_BLOCK)
    cfg = tmp / "recall.yaml"
    cfg.write_text((ROOT / "config/high_recall_config.yaml").read_text()
                   + "\nacs:\n  backend: networkx\n")
    (tmp / "queries.json").write_text(json.dumps([
        {"query": "What color is the square?", "groundtruth": "red"},
        {"query": "What moves in the frames?", "groundtruth": "a square"}]))
    env = {**os.environ, "VIDGRAPH_TORCH_DEVICE": "cuda",
           "PYTHONPATH": os.pathsep.join(
               [str(tmp / "block"), str(ROOT),
                os.environ.get("PYTHONPATH", "")])}

    def cli(*args) -> str:
        res = subprocess.run(
            [sys.executable, "-m", "vidgraph_tpu_torch.cli.main", *args],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, \
            f"{args[0]} exited {res.returncode}:\n{res.stderr[-3000:]}"
        return res.stdout

    uuid = cli("kg", "--config", str(cfg), "--vlm-output",
               str(vlm_output)).strip().rsplit("UUID: ", 1)[1]
    cli("batch-retrieve", "--config", str(cfg), "--graph-uuid", uuid,
        "--input", "queries.json", "--output", "results.json")
    results = json.loads((tmp / "results.json").read_text())
    assert len(results) == 2, results
    snap = json.loads((tmp / "graph_store" / f"{uuid}.json").read_text())
    return {"uuid": uuid, "chunks": len(snap.get("chunks", {})),
            "entities": len(snap.get("entities", {}))}


def cosine_rows(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(F.cosine_similarity(a.float(), b.float(), dim=-1).min())


def planted_fault_logits(client, stack, first_logits) -> dict:
    """First-token logits of the fused client with a planted fault: the
    short-attention kernel run without its ``1/sqrt(hd)`` scale (q handed
    over times ``sqrt(hd)``).  They show how far a wrong kernel moves what
    ``VISION_LOGIT_TOL`` holds."""
    from vidgraph_tpu_torch.models import vit

    fused = vit.fused_short_attention

    def unscaled(q, k, v):
        return fused((q * q.shape[-1] ** 0.5).contiguous(), k.contiguous(),
                     v.contiguous())
    vit.fused_short_attention = unscaled
    try:
        emb = client.embed_frames(stack)
    finally:
        vit.fused_short_attention = fused
    sound = client.embed_frames(stack)
    return {"logits": first_logits(emb, True),
            "cosine": cosine_rows(emb, sound)}


def phase_vision(seed: int, card: str) -> dict:
    from vidgraph_tpu_torch.core.config import PipelineConfig
    from vidgraph_tpu_torch.core.profiling import cuda_ms
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     generate, init_params,
                                                     vision_prefill)
    from vidgraph_tpu_torch.models.checkpoint import save_params
    from vidgraph_tpu_torch.models.vit import (ViTConfig, init_vision_tower,
                                               param_tree)
    from vidgraph_tpu_torch.ops.preprocess import (preprocess_frames,
                                                   preprocess_ref)
    from vidgraph_tpu_torch.pipeline import vlm_extractor
    from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient

    vlm_extractor.iter_chunk_frames = (
        lambda path, secs, per_chunk, *a: synthetic_chunks(
            VISION_CHUNKS, per_chunk, secs))
    vlm_extractor.count_chunks = lambda path, secs: VISION_CHUNKS
    gen = torch.Generator().manual_seed(seed)
    tower = init_vision_tower(ViTConfig.b32(), gen)
    cap = init_params(CaptionerConfig.base(), gen)
    n_layers_vit, n_layers_cap = tower.cfg.layers, CaptionerConfig.base().layers
    old_cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            ckpt = save_params({"vit": param_tree(tower), "cap": cap},
                               str(tmp / "vlm.npz"))
            del tower, cap
            cfg = PipelineConfig()
            cfg.backend.vlm = "tpu"
            cfg.vlm.checkpoint_path = ckpt
            cfg.vlm.preprocess = "device"
            cfg.vlm.fast_resize = True
            einsum = extract(cfg, None, tmp / "vlm_output.json")
            fused_client = TPUVLMClient(
                vit_cfg=ViTConfig(attn_impl="fused"), checkpoint=ckpt,
                preprocess="device", fast_resize=True)
            fused = extract(cfg, fused_client, tmp / "vlm_output_fused.json")
            n = VISION_CHUNKS
            for name, run, attn in (("einsum", einsum, 0),
                                    ("fused", fused, n_layers_vit * n)):
                c = run["counts"]
                log(f"phase 11: {name}: launches {json.dumps(c)} for {n} "
                    f"chunks, wall {run['wall_s']:.3f} s")
                assert c["preprocess"] >= n, f"{name}: {c}"
                assert c["short_attention"] == attn, f"{name}: {c}"
                assert c["flash"] == n_layers_cap * n, f"{name}: {c}"
                assert c["plain"] == 0, f"{name}: a plain version served {c}"
            same = sum(a["content"] == b["content"] for a, b in
                       zip(einsum["results"], fused["results"]))

            client = fused_client
            chunk = next(synthetic_chunks(1, VISION_FRAMES, 5.0))[2]
            stack = np.stack(chunk)
            einsum_tower = type(client.vit)(ViTConfig())
            einsum_tower.load_state_dict(client.vit.state_dict())
            einsum_tower = einsum_tower.cuda().eval()

            def first_logits(emb, flash):
                vis = client.vision_prefixes([chunk], emb)
                return vision_prefill(client._serve_params, client.cap_cfg,
                                      vis, client.max_new, flash=flash)[0]
            with torch.no_grad():
                xin = torch.from_numpy(stack).cuda()
                x = preprocess_frames(xin, 224, fast=True)
                emb_f, emb_e = client.vit(x), einsum_tower(x)
                cos_modes = cosine_rows(emb_f, emb_e)
                assert cos_modes >= 0.999, f"einsum vs fused: {cos_modes}"
                # every kernel (preprocessing, short attention, flash)
                # against every plain version: preprocess_ref, the einsum
                # attention (short_attention_ref's arithmetic) and the
                # plain prefill
                emb_k = client.embed_frames(stack)
                emb_p = einsum_tower(preprocess_ref(xin, 224, fast=True))
                emb_err = float((emb_k - emb_p).abs().max())
                cos_plain = cosine_rows(emb_k, emb_p)
                assert cos_plain >= 0.999, f"kernels vs plain: {cos_plain}"
                lk, lp = first_logits(emb_k, True), first_logits(emb_p, False)
                fault = planted_fault_logits(client, stack, first_logits)
            torch.cuda.synchronize()
            err = float((lk - lp).abs().max())
            assert bool(torch.isfinite(lk).all()) and err <= VISION_LOGIT_TOL, \
                f"first-token logits differ by {err} > {VISION_LOGIT_TOL}"
            fault_err = float((fault["logits"] - lp).abs().max())
            assert fault_err > VISION_LOGIT_TOL, \
                f"a planted fault moved the logits by {fault_err} only"
            top2 = torch.topk(lp, 2, dim=-1).values
            decided = (top2[:, 0] - top2[:, 1]) > VISION_LOGIT_TOL
            first_same = lk.argmax(-1) == lp.argmax(-1)
            assert bool(first_same[decided].all()), "a first token differs"

            times = {}
            frames160 = np.concatenate([stack] * 32)
            for nf, frames in ((5, stack), (160, frames160)):
                xin = torch.from_numpy(frames).cuda()
                xp = preprocess_frames(xin, 224, fast=True)
                with torch.no_grad():
                    times[f"vit_fused_{nf}_ms"] = cuda_ms(
                        lambda: client.vit(xp), reps=10)
                    times[f"vit_einsum_{nf}_ms"] = cuda_ms(
                        lambda: einsum_tower(xp), reps=10)
                times[f"upload_{nf}_ms"] = cuda_ms(
                    lambda: torch.from_numpy(frames).cuda())
                times[f"preprocess_{nf}_ms"] = cuda_ms(
                    lambda: preprocess_frames(xin, 224, fast=True))
            chunks = [c for _, _, c in synthetic_chunks(
                VISION_CHUNKS, VISION_FRAMES, 5.0)]
            vis = client.vision_prefixes(
                chunks, client.embed_frames(np.concatenate(chunks)))
            gen_s = {}
            for b in (1, VISION_CHUNKS):
                generate(client._serve_params, client.cap_cfg, vis[:b],
                         client.max_new)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = generate(client._serve_params, client.cap_cfg,
                                vis[:b], client.max_new)
                torch.cuda.synchronize()
                gen_s[f"b{b}"] = time.perf_counter() - t0
                assert toks.shape == (b, client.max_new)
            times["generate_s"] = gen_s
            cli = vision_cli(tmp / "vlm_output.json", tmp)
        finally:
            os.chdir(old_cwd)
    per_chunk = {name: statistics.mean(r["processing_time"]
                                       for r in run["results"])
                 for name, run in (("einsum", einsum), ("fused", fused))}
    out = {"counts": {"einsum": einsum["counts"], "fused": fused["counts"]},
           "s_per_chunk": per_chunk,
           "wall_s": {"einsum": einsum["wall_s"], "fused": fused["wall_s"]},
           "captions_equal_across_modes": same,
           "embedding_cosine_einsum_vs_fused": cos_modes,
           "embeddings_kernels_vs_plain": {"min_cosine": cos_plain,
                                           "max_abs_err": emb_err},
           "planted_fault": {"fault": "short attention without 1/sqrt(hd)",
                             "embedding_min_cosine": fault["cosine"],
                             "first_token_logits_max_abs_diff": fault_err},
           "first_token_logits": {
               "max_abs_err": err, "tol": VISION_LOGIT_TOL,
               "first_tokens_equal": bool(first_same.all()),
               "decided": bool(decided.all()),
               "logit_scale": float(lp.abs().max())},
           "times": times, "cli": cli}
    log(f"phase 11: the vision path at ViT-B/32 + captioner base width on "
        f"{card}: {json.dumps(out)}")
    return out


# ----------------------------------------------------------------- phase 12
Q8_SHAPES = [(2048, 6144), (2048, 2048), (2048, 8192), (8192, 2048),
             (512, 1536), (512, 512), (512, 2048), (2048, 512)]
Q8_COPIES = 20
# rows held against the plain version: decode steps, 5 (no multiple of 16),
# and what phase 13 gives the kernel besides: B = 4 (generate's steps, and
# its prefill of 4 x 9 = 36 rows) and sequence_logits' 40.  Between them
# every row-tile count (1 to 4 tiles of 16) runs.
Q8_CHECK_M = (1, 4, 5, 8, 32, 36, 40, 64)


def rotating(fn, items):
    """``fn`` over ``items`` in turn, one a call: each of a replay's 20
    calls reads another copy of the weights."""
    turn = itertools.cycle(items)
    return lambda: fn(next(turn))


def check_q8(q8, x, q, s) -> tuple:
    """The kernel twice (equal bits) and against the plain version;
    returns (max |err|, max |plain|)."""
    got = q8.q8_matmul(x, q, s)
    again = q8.q8_matmul(x, q, s)
    torch.cuda.synchronize()
    ref = q8.q8_matmul_ref(x, q, s)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert bool(torch.isfinite(got).all()), "q8_matmul: not finite"
    assert torch.equal(got, again), \
        f"q8_matmul {tuple(x.shape)} x {tuple(q.shape)}: two runs differ"
    err, top = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= q8.TOL_REL * top, \
        f"q8_matmul {tuple(x.shape)} x {tuple(q.shape)}: max |err| {err} " \
        f"> {q8.TOL_REL} x {top}"
    return err, top


def phase_q8_matmul(seed: int, card: str) -> dict:
    from vidgraph_tpu_torch.core.profiling import graph_ms
    from vidgraph_tpu_torch.models import quant8
    from vidgraph_tpu_torch.ops import q8_matmul as q8

    rng = np.random.default_rng(seed + 5)
    bf16 = torch.bfloat16

    def activations(m, k, scale=1.0):
        return torch.from_numpy(rng.standard_normal(
            (m, k), dtype=np.float32) * scale).to("cuda", bf16)

    rows, worst_abs, worst_rel = {}, 0.0, 0.0
    int8pack_reason = None
    for k, n in Q8_SHAPES:
        w = torch.from_numpy(rng.standard_normal(
            (k, n), dtype=np.float32) * 0.02).cuda()
        wq = quant8.quantize_matrix(w)
        for m in Q8_CHECK_M:
            err, top = check_q8(q8, activations(m, k), wq.q, wq.s)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel,
                                                            err / top)
        qs = [wq.q.clone() for _ in range(Q8_COPIES)]
        qts = [q.t().contiguous() for q in qs]
        ws = [w.to(bf16) for _ in range(Q8_COPIES)]
        s, s16 = wq.s, wq.s.to(bf16)
        for m in (1, 8, 32):
            x = activations(m, k)
            row = {
                "kernel_ms": graph_ms(rotating(
                    lambda q: q8.q8_matmul(x, q, s), qs)),
                "splits": q8.split_k(m, k, n),
                "plain_ms": graph_ms(rotating(
                    lambda q: q8.q8_matmul_ref(x, q, s), qs)),
                "a16_ms": graph_ms(rotating(
                    lambda q: ((x @ q.to(bf16)).float() * s).to(bf16), qs)),
                "cublas_bf16_ms": graph_ms(rotating(lambda v: x @ v, ws)),
                "int8pack_ms": None,
                **bound(k * n + 2 * m * k + 4 * n + 4 * m * n,
                        2.0 * m * k * n, BF16_FLOPS),
                "bf16_bound_ms": bound(2 * k * n + 2 * m * k + 2 * m * n,
                                       2.0 * m * k * n,
                                       BF16_FLOPS)["bound_ms"]}
            if int8pack_reason is None:
                try:
                    row["int8pack_ms"] = graph_ms(rotating(
                        lambda qt: torch._weight_int8pack_mm(x, qt, s16),
                        qts))
                except (RuntimeError, AttributeError,
                        NotImplementedError) as exc:
                    int8pack_reason = f"{type(exc).__name__}: {exc}"[:300]
                    torch.cuda.synchronize()
            rows[f"K{k}_N{n}_M{m}"] = row
        del qs, qts, ws, w, wq
        torch.cuda.empty_cache()
    # a column of zeros (its scale is the floor) and |x| up to 1e3
    w = torch.from_numpy(rng.standard_normal(
        (2048, 2048), dtype=np.float32) * 0.02).cuda()
    w[:, 3] = 0.0
    wq = quant8.quantize_matrix(w)
    x = activations(8, 2048)
    x = (x.float() / x.float().abs().max() * 1e3).to(bf16)
    assert float(wq.s[3]) == float(np.float32(1e-8))
    err, top = check_q8(q8, x, wq.q, wq.s)
    assert not bool(q8.q8_matmul(x, wq.q, wq.s)[:, 3].any())
    worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / top)
    if int8pack_reason:
        log(f"phase 12: torch._weight_int8pack_mm does not run here: "
            f"{int8pack_reason}")
    log(f"phase 12: q8_matmul within {q8.TOL_REL} x max |plain| of the plain "
        f"version at {len(Q8_SHAPES)} (K, N) x M "
        f"{'/'.join(map(str, Q8_CHECK_M))} (worst max "
        f"|err| / max |plain| {worst_rel:.3e}), two runs equal bit for bit; "
        f"times on {card} (ms; device time per call, 20 calls replayed "
        f"from a CUDA graph over 20 copies of the weights): "
        f"{json.dumps(rows)}")
    return {"rows": rows, "max_abs_err": worst_abs, "max_rel_err": worst_rel,
            "int8pack_reason": int8pack_reason}


# ----------------------------------------------------------------- phase 13
QUANT_CHUNKS, QUANT_NEW = 2, 64


def flat_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.flatten().double(), b.flatten().double()
    return float(a @ b / (a.norm() * b.norm()))


def phase_quantized(seed: int, card: str) -> dict:
    from vidgraph_tpu_torch.cli.main import main as cli_main
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     decode_steps, generate,
                                                     init_params)
    from vidgraph_tpu_torch.models.checkpoint import save_params
    from vidgraph_tpu_torch.models.quant8 import is_q8, tree_bytes
    from vidgraph_tpu_torch.models.vit import (ViTConfig, init_vision_tower,
                                               param_tree)
    from vidgraph_tpu_torch.ops import q8_matmul as q8
    from vidgraph_tpu_torch.pipeline import vlm_extractor
    from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient

    sys.path.insert(0, str(ROOT / "scripts"))
    import profile_torch_int8_decode as p8

    large = CaptionerConfig.large()
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed + 6)
    chunks = [c for _, _, c in synthetic_chunks(QUANT_CHUNKS, VISION_FRAMES,
                                                5.0)]
    old_cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            tower = init_vision_tower(ViTConfig.b32(), gen)
            cap = init_params(large, gen, param_dtype=torch.bfloat16)
            ckpt = save_params({"vit": param_tree(tower), "cap": cap},
                               str(tmp / "vlm_large.npz"))
            del tower, cap
            log(f"phase 13: seed weights for ViT-B/32 + CaptionerConfig."
                f"large() written in {time.perf_counter() - t0:.1f} s "
                f"({Path(ckpt).stat().st_size / 1e9:.2f} GB npz)")

            # (i) the three clients a config can ask for
            clients, captions, nbytes, caption_s = {}, {}, {}, {}
            for name, quantize in (("bf16", None), ("int8", "int8"),
                                   ("int8_a8", "int8_a8")):
                t0 = time.perf_counter()
                client = TPUVLMClient(cap_cfg=large, checkpoint=ckpt,
                                      param_dtype=torch.bfloat16,
                                      quantize=quantize, preprocess="device")
                load_s = time.perf_counter() - t0
                assert client.quantize == quantize
                assert client.cap_cfg.qmode == {"int8_a8": "a8"}.get(name,
                                                                     "a16")
                assert is_q8(client._serve_params["blocks"][0]["qkv_w"]) \
                    == (quantize is not None)
                q8.reset_counts()
                t0 = time.perf_counter()
                captions[name] = client.caption_batch_sync(chunks)
                torch.cuda.synchronize()
                caption_s[name] = {"load_s": load_s,
                                   "caption_s": time.perf_counter() - t0}
                assert len(captions[name]) == QUANT_CHUNKS and all(
                    isinstance(c, str) for c in captions[name])
                assert q8.LAUNCHES["q8_matmul"] == 0 and q8.REF_CALLS == 0, \
                    f"{name}: a config value reached the a16p kernel"
                nbytes[name] = tree_bytes(client.cap_params)
                if name != "int8_a8":
                    clients[name] = client
                del client
            ratio = nbytes["int8"] / nbytes["bf16"]
            assert nbytes["int8"] == nbytes["int8_a8"] and ratio < 0.55, nbytes
            log(f"phase 13: three clients captioned {QUANT_CHUNKS} chunks; "
                f"tree bytes {json.dumps(nbytes)} (int8 / bf16 {ratio:.4f}); "
                f"{json.dumps(caption_s)}")

            # (ii) the kernel's path: the int8 tree with qmode a16p
            qtree = clients["int8"]._serve_params
            ftree = clients["bf16"]._serve_params
            qcfg = {m: dataclasses.replace(large, qmode=m)
                    for m in ("a16", "a8", "a16p")}
            per_step = 4 * large.layers
            launches = {}
            for b in (4, 8):
                vis = torch.from_numpy(rng.standard_normal(
                    (b, large.num_vision_tokens, large.vision_dim),
                    dtype=np.float32)).cuda()
                q8.reset_counts()
                toks = generate(qtree, qcfg["a16p"], vis, max_new=QUANT_NEW)
                torch.cuda.synchronize()
                got = {"kernel": q8.LAUNCHES["q8_matmul"],
                       "plain": q8.REF_CALLS}
                steps = decode_steps(toks, QUANT_NEW)
                rows = b * (large.num_vision_tokens + 1)
                want = per_step * steps + (per_step if rows <= q8.MAX_M
                                           else 0)
                launches[f"b{b}"] = {**got, "expected": want,
                                     "decode_steps": steps,
                                     "prefill_rows": rows}
                assert toks.shape == (b, QUANT_NEW)
                assert got["kernel"] == want, launches
                assert got["plain"] == 0, launches
            log(f"phase 13: generate with qmode a16p: launches "
                f"{json.dumps(launches)}")

            # (iii) logits: each int8 mode against bf16, a16p against a16,
            # and a planted fault
            vis = torch.from_numpy(rng.standard_normal(
                (4, large.num_vision_tokens, large.vision_dim),
                dtype=np.float32)).cuda()
            toks = torch.from_numpy(rng.integers(3, 250, (4, 32))).cuda()
            ref = p8.sequence_logits(ftree, large, vis, toks)
            no_flash = p8.sequence_logits(ftree, large, vis, toks,
                                          flash=False)
            flash_diff = float((ref - no_flash).abs().max())
            del no_flash
            q8.reset_counts()
            got = {m: p8.sequence_logits(qtree, qcfg[m], vis, toks)
                   for m in qcfg}
            assert q8.LAUNCHES["q8_matmul"] == 4 * per_step, q8.LAUNCHES
            sound = q8.q8_matmul
            q8.q8_matmul = lambda x, q, s: sound(x, q, torch.ones_like(s))
            try:
                fault = p8.sequence_logits(qtree, qcfg["a16p"], vis, toks)
            finally:
                q8.q8_matmul = sound
            torch.cuda.synchronize()
            cosines = {m: flat_cosine(ref, got[m]) for m in got}
            diff = float((got["a16p"] - got["a16"]).abs().max())
            fault_diff = float((fault - got["a16"]).abs().nan_to_num(
                nan=float("inf")).max())
            logits = {
                "cosine_vs_bf16": cosines,
                "max_abs_diff_vs_bf16": {
                    m: float((got[m] - ref).abs().max()) for m in got},
                "a16p_vs_a16_max_abs_diff": diff, "tol": Q8_LOGIT_TOL,
                "bf16_flash_vs_plain_attention_max_abs_diff": flash_diff,
                "flash_tol": LARGE_FLASH_LOGIT_TOL,
                "planted_fault": "q8_matmul without its scale",
                "planted_fault_max_abs_diff": fault_diff,
                "logit_scale": float(ref.abs().max())}
            log(f"phase 13: teacher-forced logits at large() width: "
                f"{json.dumps(logits)}")
            assert all(bool(torch.isfinite(v).all()) for v in got.values())
            assert min(cosines.values()) > Q8_COSINE_MIN, cosines
            assert flash_diff <= LARGE_FLASH_LOGIT_TOL, \
                f"bf16 logits with the flash kernel (16 heads of 128) " \
                f"differ from the plain attention's by {flash_diff} > " \
                f"{LARGE_FLASH_LOGIT_TOL}"
            assert diff <= Q8_LOGIT_TOL, \
                f"a16p logits differ from a16 by {diff} > {Q8_LOGIT_TOL}"
            assert fault_diff > Q8_LOGIT_TOL, \
                f"a planted fault moved the logits by {fault_diff} only"

            # (iv) the four modes' decode rates
            trees = {"bf16": (ftree, large), "int8_a16": (qtree, qcfg["a16"]),
                     "int8_a8": (qtree, qcfg["a8"]),
                     "int8_a16p": (qtree, qcfg["a16p"])}
            rates = {name: p8.bench_decode(p, c, (8, 32), QUANT_NEW, 1)
                     for name, (p, c) in trees.items()}
            row = rates["int8_a16p"]["batches"][8]
            assert row["q8_launches_per_call"] == \
                per_step * row["decode_steps"] and not row["q8_plain_calls"]
            log(f"phase 13: decode at CaptionerConfig.large() width on "
                f"{card}, {QUANT_NEW} new bytes: {json.dumps(rates)}")
            del clients, qtree, ftree, trees, got, ref, fault
            torch.cuda.empty_cache()

            # (v) vlm.quantize through the CLI, at base() width
            vlm_extractor.iter_chunk_frames = (
                lambda path, secs, per_chunk, *a: synthetic_chunks(
                    QUANT_CHUNKS, per_chunk, secs))
            vlm_extractor.count_chunks = lambda path, secs: QUANT_CHUNKS
            (tmp / "quant.yaml").write_text(
                "backend:\n  vlm: tpu\nvlm:\n  preprocess: device\n"
                "  quantize: int8\n")
            q8.reset_counts()
            rc = cli_main(["vlm", "--config", str(tmp / "quant.yaml"),
                           "--video", "synthetic_405x720.mp4", "--output",
                           str(tmp / "vlm_int8.json")])
            assert rc == 0, f"vlm with vlm.quantize int8 exited {rc}"
            data = json.loads((tmp / "vlm_int8.json").read_text())
            assert data["metadata"]["config"]["vlm"]["quantize"] == "int8"
            assert len(data["results"]) == QUANT_CHUNKS and all(
                isinstance(r["content"], str) for r in data["results"])
            assert q8.LAUNCHES["q8_matmul"] == 0 and q8.REF_CALLS == 0
            log(f"phase 13: CLI vlm with vlm.quantize int8 at base() width: "
                f"{QUANT_CHUNKS} chunks, exit 0")
        finally:
            os.chdir(old_cwd)
    return {"tree_bytes": nbytes, "int8_over_bf16_bytes": ratio,
            "clients": caption_s, "launches": launches, "logits": logits,
            "decode": rates}


# ----------------------------------------------------------------- phase 14
# (B, T, heads, hd, nv); the first three are the training paths' shapes;
# the last three hold prefixes of a tile and more (key tiles above the
# diagonal that rows below nv still see)
BWD_SHAPES = [(8, 3080, 8, 64, 8), (16, 1544, 8, 64, 8),
              (16, 1032, 16, 64, 8), (2, 1033, 16, 128, 8),
              (2, 1033, 16, 128, 0), (2, 1033, 8, 64, 8),
              (2, 1033, 8, 64, 0), (3, 40, 8, 64, 8), (3, 40, 8, 64, 0),
              (3, 40, 16, 128, 8), (1, 64, 8, 64, 64), (2, 130, 8, 64, 70),
              (2, 200, 16, 128, 100)]
BWD_TIMED = 3


def visible_pairs(t: int, nv: int) -> int:
    """(query, key) pairs of the prefix-causal mask over t tokens."""
    return sum(min(max(r, nv - 1), t - 1) + 1 for r in range(t))


def bwd_errors(fa, q, k, v, out, lse, do, grads, nv, use_delta=True) -> dict:
    """The kernels' (dq, dk, dv) against ``attention_bwd_ref``, one batch
    row at a time: max |err|, the worst excess over ``TOL_ABS + TOL_REL *
    |plain|``, and the worst Frobenius error over the plain norm."""
    err = fro = 0.0
    excess = float("-inf")
    for i in range(q.shape[0]):
        row = slice(i, i + 1)
        refs = fa.attention_bwd_ref(q[row], k[row], v[row], out[row],
                                    lse[row], do[row], nv, use_delta)
        for got, ref in zip(grads, refs):
            got = got[row].float()
            ref = ref.to(torch.bfloat16).float()
            diff = (got - ref).abs()
            err = max(err, float(diff.max()))
            excess = max(excess, float(
                (diff - fa.TOL_ABS - fa.TOL_REL * ref.abs()).max()))
            fro = max(fro, float(diff.norm())
                      / max(float(ref.norm()), 1e-12))
    return {"max_abs_err": err, "excess": excess, "rel_fro": fro}


def library_sdpa_train(q, k, v, do, mask) -> dict:
    """The yardstick of the training attention, never called by the port:
    ``F.scaled_dot_product_attention`` forward and backward under autograd
    with the boolean prefix mask; medians of the forward alone and of the
    forward + backward, and the device kernels PyTorch chose."""
    from vidgraph_tpu_torch.core.profiling import cuda_ms

    ql, kl, vl = (z.detach().clone().requires_grad_(True) for z in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(
            ql.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2),
            attn_mask=mask)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (ql, kl, vl), do.transpose(1, 2))

    with torch.no_grad():
        fwd_ms = cuda_ms(fwd, reps=10)
    both_ms = cuda_ms(fwd_bwd, reps=10)
    return {"library_fwd_ms": fwd_ms, "library_fwd_bwd_ms": both_ms,
            "library_bwd_ms": both_ms - fwd_ms,
            "library_kernels": device_kernels(fwd_bwd)}


def phase_flash_backward(seed: int, card: str) -> dict:
    from vidgraph_tpu_torch.core.profiling import cuda_ms
    from vidgraph_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(seed + 14)
    rows = {}
    planted = None
    for n, (b, t, h, hd, nv) in enumerate(BWD_SHAPES):
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (b, t, h, hd), dtype=np.float32)).to("cuda", torch.bfloat16)
            for _ in range(4))

        def grads():
            ql, kl, vl = (z.detach().requires_grad_(True) for z in (q, k, v))
            out = fa.flash_attention(ql, kl, vl, nv)
            assert out.grad_fn is not None, "the output is cut from the graph"
            return out.detach(), torch.autograd.grad(out, (ql, kl, vl), do)

        out, first = grads()
        _, second = grads()
        torch.cuda.synchronize()
        # dk and dv: bit-equal; dq: summed by atomics, compared before its
        # rounding to bf16
        same_bits = all(torch.equal(a, c) for a, c in zip(first[1:],
                                                          second[1:]))
        lse = fa._cuda_flash(q, k, v, nv, with_lse=True)[1]
        accs = []
        for _ in range(2):
            delta, acc = fa._cuda_delta(out, do)
            fa._cuda_bwd_fused(q, k, v, do, lse, delta, acc, nv)
            accs.append(acc)
        torch.cuda.synchronize()
        dq_run_rel = float((accs[0] - accs[1]).norm()) / max(
            float(accs[0].norm()), 1e-30)
        scale = 1.0 / math.sqrt(hd)
        convert_err = float((fa._cuda_dq_convert(accs[0]).float() - (
            accs[0] * scale).to(torch.bfloat16).float()).abs().max())
        lse_err = max(float((lse[i] - fa.lse_ref(q[i:i + 1], k[i:i + 1],
                                                 nv)[0]).abs().max())
                      for i in range(b))
        delta_err = float((delta - (do.float() * out.float()).sum(-1)
                           .transpose(1, 2)).abs().max())
        row = {**bwd_errors(fa, q, k, v, out, lse, do, first, nv),
               "dk_dv_bit_equal": same_bits, "dq_run_rel": dq_run_rel,
               "convert_err": convert_err, "lse_err": lse_err,
               "delta_err": delta_err}
        name = f"b{b}_T{t}_h{h}x{hd}_nv{nv}"
        assert all(bool(torch.isfinite(g).all()) for g in first), name
        assert row["excess"] <= 0 and row["rel_fro"] <= BWD_REL_FRO, \
            f"flash backward {name}: {row}"
        assert same_bits, f"flash backward {name}: two runs' dk, dv differ"
        assert dq_run_rel <= DQ_RUN_REL and convert_err == 0.0, \
            f"flash backward {name}: {row}"
        assert lse_err <= 2e-3 and delta_err <= 1e-3 * max(
            1.0, float(delta.abs().max())), f"{name}: {row}"
        if planted is None and t <= 1100:
            bad = bwd_errors(fa, q, k, v, out, lse, do, first, nv,
                             use_delta=False)
            assert bad["excess"] > 0 and bad["rel_fro"] > BWD_REL_FRO, \
                f"the backward without delta passes at {name}: {bad}"
            planted = {"shape": name, **bad}
        if n < BWD_TIMED:
            pairs = visible_pairs(t, nv)
            tensor = b * t * h * hd * 2                 # one bf16 tensor
            vec = b * h * t * 4                         # lse or delta
            product = 2.0 * b * h * hd * pairs          # one T x T product
            mask = fa.prefix_causal_mask(t, nv, q.device)
            row.update({
                "fwd_lse_ms": cuda_ms(lambda: fa._cuda_flash(
                    q, k, v, nv, with_lse=True)),
                "delta_ms": cuda_ms(lambda: fa._cuda_delta(out, do)),
                "fused_ms": cuda_ms(lambda: fa._cuda_bwd_fused(
                    q, k, v, do, lse, delta, acc, nv)),
                "convert_ms": cuda_ms(lambda: fa._cuda_dq_convert(acc)),
                "bwd_ms": cuda_ms(lambda: fa._cuda_flash_bwd(
                    q, k, v, out, lse, do, nv)),
                "plain_delta_ms": cuda_ms(
                    lambda: (do.float() * out.float()).sum(-1)
                    .transpose(1, 2).contiguous()),
                "plain_convert_ms": cuda_ms(
                    lambda: (acc * scale).to(torch.bfloat16)),
                "bound": {
                    "fwd": bound(4 * tensor + vec, 2 * product, BF16_FLOPS),
                    # o and dO in, delta out, the float32 dq accumulator
                    # (two bf16 tensors' bytes) zeroed
                    "delta": bound(4 * tensor + vec, 2.0 * b * t * h * hd,
                                   F32_FLOPS),
                    # q, k, v, dO, L, delta in; dk, dv and the dq
                    # accumulator out; S, dP, dV, dK, dQ: 5 products
                    "fused": bound(8 * tensor + 2 * vec, 5 * product,
                                   BF16_FLOPS),
                    "convert": bound(3 * tensor, 0.0, F32_FLOPS),
                    # the whole backward: q, k, v, o, dO, L in, dq, dk,
                    # dv out, 5 products
                    "bwd": bound(8 * tensor + vec, 5 * product,
                                 BF16_FLOPS)}})
            del first, second
            torch.cuda.empty_cache()
            row["plain_bwd_ms"] = cuda_ms(
                lambda: fa.attention_bwd_ref(q, k, v, out, lse, do, nv),
                reps=3, warmup=1)
            torch.cuda.empty_cache()
            row.update(library_sdpa_train(q, k, v, do, mask))
        rows[name] = row
        del q, k, v, do, out, lse, delta, acc, accs
        torch.cuda.empty_cache()
    log(f"phase 14: flash backward kernels within {fa.TOL_ABS} + "
        f"{fa.TOL_REL} x |plain| and {BWD_REL_FRO} of the plain norm, two "
        f"runs' dk, dv bit-equal and dq accumulators within {DQ_RUN_REL}; "
        f"planted fault (no delta) {json.dumps(planted)}; "
        f"times on {card} (median, ms): {json.dumps(rows)}")
    return {"rows": rows, "planted": planted}


# ----------------------------------------------------------------- phase 15
def load_script(name: str):
    """A trainer script of ``scripts/`` as a module (its ``main(argv)`` is
    the entry point a user runs)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def training_corpus(tmp: Path, seed: int) -> Path:
    """The golden vlm output plus synthetic captions, as a vlm_output."""
    from vidgraph_tpu_torch.models import instruct_data

    rng = random.Random(seed)
    results = json.loads((ROOT / "tests/golden/vlm_output_golden.json")
                         .read_text())["results"]
    results = results + [
        {"content": " ".join(instruct_data.synth_sentence(rng)
                             for _ in range(4))} for _ in range(10)]
    path = tmp / "train_corpus.json"
    path.write_text(json.dumps({"results": results}))
    return path


def leaf_grads(params, loss_of) -> tuple:
    """(loss, {leaf: gradient or None}) of ``loss_of()``, a training
    loss of ``params``."""
    from vidgraph_tpu_torch.models.checkpoint import tree_leaves

    for _, p in tree_leaves(params):
        p.grad = None
    loss = loss_of()
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {k: p.grad for k, p in tree_leaves(params)}


def worst_leaf(got: dict, ref: dict) -> tuple:
    """(leaf, max |diff| / max |ref|) of the worst leaf; a missing
    gradient counts as zeros."""
    worst = ("", 0.0)
    for key, r in ref.items():
        g = got[key] if got[key] is not None else torch.zeros_like(r)
        rel = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        if rel > worst[1]:
            worst = (key, rel)
    return worst


def phase_train_instruct(seed: int, card: str, tmp: Path) -> dict:
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     init_params)
    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.services.llm_client import make_chat_client

    mod = load_script("train_torch_instruct_lm")
    out = tmp / "instruct_lm.npz"
    steps = 12
    fa.reset_counts()
    t0 = time.perf_counter()
    rec = mod.main([
        "--corpus", str(training_corpus(tmp, seed)), "--steps", str(steps),
        "--batch", "8", "--seq-len", "3072", "--flash", "--seed", str(seed),
        "--n-questions", "4", "--n-pre", "12", "--n-synth-answers", "6",
        "--n-instr", "4", "--n-consol", "4", "--n-copy", "4",
        "--eval-count", "4", "--out", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, plain = dict(fa.LAUNCHES), fa.REF_CALLS
    layers = rec["layers"]
    fwd_want = layers * (steps + rec["held_evals"] * rec["held_buckets"]
                         + rec["held_examples"])
    assert rec["attention"] == "flash" and rec["remat"] is False, rec
    assert counts["flash_bwd_fused"] == counts["flash_bwd_dq_convert"] == \
        counts["flash_bwd_delta"] == layers * steps, counts
    assert counts["flash_fwd"] == fwd_want, (counts, fwd_want)
    assert plain == 0, f"the plain attention served {plain} calls"
    assert all(np.isfinite(rec["losses"])), rec["losses"]
    assert np.isfinite(rec["held_last"]) and \
        rec["held_last"] < rec["held_first"], \
        (rec["held_first"], rec["held_last"])
    assert [8, 3072] in rec["batch_shapes"], rec["batch_shapes"]

    # the first batch from the seed weights: kernels against einsum + remat
    cfg = CaptionerConfig.chat()
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device=torch.device("cuda"), requires_grad=True)
    toks, plens = (torch.as_tensor(a, device="cuda")
                   for a in rec["first_batch"])
    def loss_of(remat, flash):
        return lambda: mod.instruct_loss(params, cfg, toks, plens, remat,
                                         flash)
    loss_f, g_flash = leaf_grads(params, loss_of(False, True))
    assert abs(loss_f - rec["losses"][0]) < 1e-3, (loss_f, rec["losses"][0])
    loss_e, g_plain = leaf_grads(params, loss_of(True, False))
    leaf, rel = worst_leaf(g_flash, g_plain)
    assert abs(loss_f - loss_e) < 2e-2 and rel < TRAIN_GRAD_TOL, \
        f"gradients with the kernels: {leaf} differs by {rel} of its max"
    # planted fault: the attention output cut from the graph
    real = fa.FlashAttentionFn.apply
    fa.FlashAttentionFn.apply = staticmethod(
        lambda q, k, v, nv: fa._cuda_flash(q.detach(), k.detach(),
                                           v.detach(), nv)[0])
    try:
        _, g_cut = leaf_grads(params, loss_of(False, True))
    finally:
        fa.FlashAttentionFn.apply = real
    cut_leaf, cut_rel = worst_leaf(g_cut, g_plain)
    assert cut_rel > TRAIN_GRAD_TOL, \
        f"a gradient cut at the attention passes the check ({cut_rel})"
    del params, g_flash, g_plain, g_cut
    torch.cuda.empty_cache()

    # the trained checkpoint serves through backend.llm: tpu
    fa.reset_counts()
    client = make_chat_client("tpu", checkpoint_path=str(out))
    text = asyncio.run(client.complete(
        "TEXT TO ANALYSE:\nA red square moves left.\n\nTRIPLET LINES:\n",
        max_tokens=64))
    assert isinstance(text, str) and client.MAX_NEW == 1024
    assert fa.LAUNCHES["flash_fwd"] == layers and fa.REF_CALLS == 0
    del client
    torch.cuda.empty_cache()
    timed = rec["losses"]
    res = {"steps": steps, "wall_s": wall, "launches": counts,
           "flash_fwd_expected": fwd_want, "batch_shapes": rec["batch_shapes"],
           "first_loss": timed[0], "last_loss": timed[-1],
           "held_first": rec["held_first"], "held_last": rec["held_last"],
           "grad_check": {"loss_flash": loss_f, "loss_einsum_remat": loss_e,
                          "worst_leaf": leaf, "worst_rel": rel,
                          "planted_leaf": cut_leaf, "planted_rel": cut_rel,
                          "tol": TRAIN_GRAD_TOL},
           "served_chars": len(text), "eval": rec["eval"]}
    log(f"phase 15a: instruct trainer at CaptionerConfig.chat() width, "
        f"8 x 3072, flash, on {card}: {json.dumps(res)}")
    return res


def midscale_grad_check(mod, seed: int, corpus: str) -> dict:
    """Every leaf's gradient of the mid-scale loss at its full width (16
    heads x 1024) from the seed weights, on 4 packed windows of 1024: the
    kernels against the masked einsum with remat."""
    from vidgraph_tpu_torch.models.captioner import init_params

    cfg = mod.mid_config(1024)
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device=torch.device("cuda"), requires_grad=True)
    captions = [r["content"] for r in json.loads(Path(corpus).read_text())[
        "results"] if r.get("content")]
    toks = mod.pack_corpus(captions, 1024, random.Random(seed))
    batch = torch.as_tensor(toks[:4], device="cuda")
    loss_f, g_flash = leaf_grads(
        params, lambda: mod.lm_loss(params, cfg, batch, False, True))
    loss_e, g_plain = leaf_grads(
        params, lambda: mod.lm_loss(params, cfg, batch, True, False))
    leaf, rel = worst_leaf(g_flash, g_plain)
    assert abs(loss_f - loss_e) < 2e-2 and rel < TRAIN_GRAD_TOL, \
        f"mid-scale gradients with the kernels: {leaf} differs by {rel}"
    del params, g_flash, g_plain
    torch.cuda.empty_cache()
    return {"loss_flash": loss_f, "loss_einsum_remat": loss_e,
            "worst_leaf": leaf, "worst_rel": rel, "tol": TRAIN_GRAD_TOL}


def phase_train_midscale(seed: int, card: str, tmp: Path) -> dict:
    from vidgraph_tpu_torch.ops import flash_attention as fa

    mod = load_script("train_torch_midscale")
    corpus = str(training_corpus(tmp, seed))
    runs = {}
    steps = 12
    for name, argv in (("flash", ["--flash"]), ("einsum_remat", [])):
        fa.reset_counts()
        torch.cuda.empty_cache()
        rec = mod.main(["--corpus", corpus, "--steps", str(steps), "--seed",
                        str(seed), "--out", str(tmp / f"mid_{name}.npz"),
                        *argv])
        torch.cuda.synchronize()
        assert rec["bf16_roundtrip_exact"], rec
        assert all(np.isfinite(rec["losses"])), rec["losses"]
        assert rec["config"] == "16x1024" and rec["batch"] == 16 and \
            rec["seq_len"] == 1024, rec
        runs[name] = {**{k: rec[k] for k in (
            "attention", "remat", "params_m", "step_ms", "tokens_per_sec",
            "train_mfu", "mfu_peak", "peak_memory_gb", "first_loss",
            "last_loss", "bf16_roundtrip_exact", "decode_sample")},
            "losses": rec["losses"],
            "launches": dict(fa.LAUNCHES), "plain_calls": fa.REF_CALLS}
    fl, ein = runs["flash"], runs["einsum_remat"]
    assert fl["attention"] == "flash" and fl["remat"] is False, fl
    assert ein["attention"] == "einsum" and ein["remat"] is True, ein
    assert fl["last_loss"] < fl["first_loss"], fl
    # 16 layers x 12 steps, plus the decode sample's prefill
    assert fl["launches"]["flash_bwd_fused"] == fl["launches"][
        "flash_bwd_dq_convert"] == 16 * steps, fl["launches"]
    assert fl["launches"]["flash_fwd"] == 16 * steps + 16, fl["launches"]
    assert fl["plain_calls"] == 0 and ein["launches"]["flash_fwd"] == 0
    # the same seed gives both runs the same weights, batches and schedule
    gaps = [abs(a - b) for a, b in zip(fl["losses"][:4], ein["losses"][:4])]
    assert max(gaps) <= MIDSCALE_LOSS_TOL, \
        f"mid-scale flash and einsum + remat losses part: {gaps}"
    res = {"runs": runs, "loss_gaps_first4": gaps,
           "loss_tol": MIDSCALE_LOSS_TOL,
           "grad_check": midscale_grad_check(mod, seed, corpus)}
    log(f"phase 15b: mid-scale trainer, 204M, 16 x 1024, on {card}: "
        f"{json.dumps(res)}")
    return res


def phase_train_state(seed: int, card: str) -> dict:
    from vidgraph_tpu_torch.models.captioner import CaptionerConfig
    from vidgraph_tpu_torch.models.tokenizer import batch_encode
    from vidgraph_tpu_torch.models.train import TrainState
    from vidgraph_tpu_torch.models.vit import ViTConfig

    state = TrainState.create(
        ViTConfig.b32(), CaptionerConfig.base(), torch.device("cuda"),
        learning_rate=3e-4, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 15)
    images = rng.standard_normal((8, 224, 224, 3), dtype=np.float32)
    tokens = batch_encode(["The scene shows a red object on a dark "
                           "background."] * 8, 96)
    batch = state.shard_batch(images, tokens)
    torch.cuda.reset_peak_memory_stats()
    losses, t0 = [], time.perf_counter()
    for _ in range(3):
        state, loss = state.step(*batch)
        losses.append(loss)
    step_s = (time.perf_counter() - t0) / 3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    res = {"losses": losses, "step_ms": step_s * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"phase 15c: TrainState, ViT-B/32 + CaptionerConfig.base(), B 8, "
        f"on {card}: {json.dumps(res)}")
    del state, batch
    torch.cuda.empty_cache()
    return res


def phase_training(seed: int, card: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        return {"instruct": phase_train_instruct(seed, card, tmp),
                "midscale": phase_train_midscale(seed, card, tmp),
                "train_state": phase_train_state(seed, card)}


# ----------------------------------------------------------------- phase 16
ACS_SIZES = (64, 96, 128, 256, 512, 926)
# tests/test_acs.py::test_xla_matches_networkx's tolerances
ACS_NAMED_TOL = {"global_efficiency": 1e-3, "avg_path_length": 1e-3,
                 "diameter_estimate": 0, "weakly_connected_components": 0,
                 "largest_wcc_size": 0, "pagerank_top10_percent": 0.5}


class GraphOf:
    """A graph store's view for ``ACSAutomata``: the nodes of an
    undirected networkx graph as entities, each edge as two relations."""

    def __init__(self, graph):
        self.entities = {f"n{i}": {} for i in graph.nodes}
        self.chunks = {}
        self.rels = [(f"n{a}", "r", f"n{b}") for a, b in graph.edges] + [
            (f"n{b}", "r", f"n{a}") for a, b in graph.edges]
        self.from_chunk = []


def acs_ms(acs, names, adj, backend: str, reps: int = 3) -> float:
    """Mean ms of a full metric pass (``_compute``) after one warm-up."""
    acs._compute(names, adj, backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        acs._compute(names, adj, backend)
    return (time.perf_counter() - t0) / reps * 1e3


def phase_acs(card: str) -> dict:
    """The ACS device sweep on the card against exact NetworkX on
    bench.py's 926-node graph, then both backends' times by graph size."""
    import networkx as nx

    from vidgraph_tpu_torch.core.config import ACSConfig
    from vidgraph_tpu_torch.pipeline import acs as tacs

    graph = nx.barabasi_albert_graph(926, 2, seed=0)
    store = GraphOf(graph)
    calls = []
    real = tacs._acs_fused

    def counted(*args, **kw):
        calls.append(args[-1])
        return real(*args, **kw)

    tacs._acs_fused = counted
    try:
        dev = tacs.ACSAutomata(store, ACSConfig(backend="auto")) \
            .update_metrics()
    finally:
        tacs._acs_fused = real
    assert "error" not in dev and calls == [1024], (dev, calls)
    exact = tacs.ACSAutomata(store, ACSConfig(
        backend="networkx", exact_efficiency_max_nodes=10 ** 6,
        betweenness_k=10 ** 6)).update_metrics()
    gaps = {}
    for key, want in exact.items():
        if key in ("computational_time", "louvain_communities",
                   "louvain_modularity"):
            continue
        tol = ACS_NAMED_TOL.get(key, ACS_OTHER_TOL)
        got = dev[key]
        if got is None or want is None:
            assert got == want, (key, got, want)
            continue
        gaps[key] = abs(got - want)
        assert gaps[key] <= tol, f"ACS {key}: device {got}, NetworkX {want}"
    times = {}
    for n in ACS_SIZES:
        g = graph if n == 926 else nx.barabasi_albert_graph(n, 2, seed=0)
        adj = nx.to_numpy_array(g).astype(np.float32)
        names = [f"n{i}" for i in range(n)]
        acs = tacs.ACSAutomata(GraphOf(g), ACSConfig())
        times[f"{n}n"] = {"device_ms": acs_ms(acs, names, adj, "xla"),
                          "networkx_ms": acs_ms(acs, names, adj,
                                                "networkx", reps=1)}
    res = {"metrics_device": dev, "metrics_networkx_exact": exact,
           "gaps": gaps, "acs_full_metrics_ms_926n":
           times["926n"]["device_ms"], "times": times,
           "auto_min_nodes": tacs._AUTO_XLA_MIN_NODES}
    log(f"phase 16: ACS device sweep on {card} equals exact NetworkX on the "
        f"926-node graph (Louvain aside); ms by graph size: "
        f"{json.dumps(res)}")
    return res


def kernel_record(kern, main_path, flash, chat, pre, short, vision, q8k,
                  quant, bwd, training) -> dict:
    """The ``kernels`` record: every kernel of the port, its launches on
    the main paths, its error against its plain version, its times and
    its bound at the shape it was timed at."""
    src = "vidgraph_tpu_torch/csrc/topk_cosine.cu"
    replaces = "vidgraph_tpu/ops/topk_cosine.py:39"
    launches = main_path["launches"]
    stages, lib = kern["stages"], kern["library"]
    dense = kern["times"]["dense_b16"]
    store_bytes = STORE_ROWS * DIM * 4
    score_ops = 2.0 * 16 * STORE_ROWS * DIM
    t, nv, b32 = 2056, 8, flash["b32_T2056"]
    pairs = sum(min(max(r, nv - 1), t - 1) + 1 for r in range(t))
    vision_counts = [vision["counts"][m] for m in ("einsum", "fused")]
    pre5 = pre["b5_405x720_fast"]
    short5 = short["b5"]
    q8row = q8k["rows"]["K2048_N8192_M32"]
    inst = training["instruct"]["launches"]
    mid = training["midscale"]["runs"]["flash"]["launches"]
    bwd_rows = bwd["rows"]
    brow = bwd_rows["b8_T3080_h8x64_nv8"]
    bwd_src = "vidgraph_tpu_torch/csrc/flash_attention_bwd.cu"
    # the call whose custom_vjp runs the TPU backward kernels, and their
    # lines in JAX's own source
    bwd_site = "vidgraph_tpu/models/captioner.py:191"
    jax_flash = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    bwd_timed = ("B=8, T=3080, 8 heads x 64, bf16, nv=8 (the instruct "
                 "trainer's long bucket)")
    return {"kernels": [
        {"name": "cosine_score_tile (top-k mode)", "route": "cuda",
         "source": src, "replaces": replaces,
         "launches": launches["score_topk"],
         "max_abs_err": stages["score_topk_b16_k5"]["max_abs_err"],
         "ms": stages["score_topk_b16_k5"]["kernel_ms"],
         "plain_ms": stages["score_topk_b16_k5"]["plain_ms"],
         "library_ms": lib["score_topk_b16_k5"],
         **bound(store_bytes + kern["partial_bytes"], score_ops, F32_FLOPS),
         "timed": "per-tile top-5 partials, B=16, 200000x512 f32"},
        {"name": "cosine_topk_merge", "route": "cuda", "source": src,
         "replaces": replaces, "launches": launches["merge"],
         "max_abs_err": stages["merge_b16_k5"]["max_abs_err"],
         "ms": stages["merge_b16_k5"]["kernel_ms"],
         "plain_ms": stages["merge_b16_k5"]["plain_ms"],
         "library_ms": lib["merge_b16_k5"],
         **bound(kern["partial_bytes"] + 16 * 5 * 8, 0.0, F32_FLOPS),
         "timed": "merge of the tiles' top-5 partials, B=16"},
        {"name": "cosine_score_tile (dense mode)", "route": "cuda",
         "source": src, "replaces": replaces,
         "launches": launches["score_dense"],
         "max_abs_err": kern["score_err"], "ms": dense["kernel_ms"],
         "plain_ms": dense["plain_ms"], "library_ms": lib["dense_b16"],
         **bound(store_bytes + 16 * STORE_ROWS * 4, score_ops, F32_FLOPS),
         "timed": "dense scores, B=16, 200000x512 f32"},
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "vidgraph_tpu_torch/csrc/flash_attention.cu",
         "replaces": "vidgraph_tpu/models/captioner.py:165",
         "launches": (chat["kg"]["flash"] + chat["benchmark"]["flash"]
                      + sum(c["flash"] for c in vision_counts)
                      + inst["flash_fwd"] + mid["flash_fwd"]),
         "max_abs_err": max(r["max_abs_err"] for r in flash.values()),
         "lse_max_abs_err": max(r["lse_err"] for r in bwd_rows.values()),
         "train_ms": brow["fwd_lse_ms"],
         "train_bound_ms": brow["bound"]["fwd"]["bound_ms"],
         "train_timed": "with the log-sum-exp written; " + bwd_timed,
         "ms": b32["kernel_ms"], "plain_ms": b32["plain_ms"],
         "library_ms": b32["library_ms"],
         "library_backends": b32["library_backends"],
         "library_kernels": b32["library_kernels"],
         **bound(4 * 32 * t * 8 * 64 * 2, 4.0 * 32 * 8 * 64 * pairs,
                 BF16_FLOPS),
         "timed": "b=32, T=2056, 8 heads x 64, bf16, nv=8"},
        {"name": "preprocess_frames", "route": "cuda",
         "source": "vidgraph_tpu_torch/csrc/preprocess.cu",
         "replaces": "vidgraph_tpu/ops/preprocess.py:30",
         "launches": sum(c["preprocess"] for c in vision_counts),
         "max_abs_err": max(r["max_abs_err"] for r in pre.values()),
         "ms": pre5["kernel_ms"], "plain_ms": pre5["plain_ms"],
         "library_ms": pre5["library_ms"], "call_ms": pre5["call_ms"],
         "bound_ms": pre5["bound_ms"], "bound_by": pre5["bound_by"],
         "timed": "5 frames 405x720 uint8 -> 224 bf16 (fast)"},
        {"name": "short_attention", "route": "cuda",
         "source": "vidgraph_tpu_torch/csrc/short_attention.cu",
         "replaces": "vidgraph_tpu/ops/short_attention.py:83",
         "launches": vision["counts"]["fused"]["short_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in short.values()),
         "ms": short5["kernel_ms"], "plain_ms": short5["plain_ms"],
         "library_ms": short5["library_ms"],
         "library_kernels": short5["library_kernels"],
         "call_ms": short5["call_ms"],
         "bound_ms": short5["bound_ms"], "bound_by": short5["bound_by"],
         "b160_ms": short["b160"]["kernel_ms"],
         "b160_library_ms": short["b160"]["library_ms"],
         "b160_bound_ms": short["b160"]["bound_ms"],
         "timed": "B=5 x 12 heads, N=50, hd=64, bf16"},
        {"name": "q8_matmul", "route": "cuda",
         "source": "vidgraph_tpu_torch/csrc/q8_matmul.cu",
         "replaces": "vidgraph_tpu/ops/q8_matmul.py:62",
         "launches": sum(r["kernel"] for r in quant["launches"].values()),
         "max_abs_err": q8k["max_abs_err"],
         "max_rel_err": q8k["max_rel_err"],
         "ms": q8row["kernel_ms"], "plain_ms": q8row["plain_ms"],
         "library_ms": q8row["int8pack_ms"],
         "library": "torch._weight_int8pack_mm",
         "a16_ms": q8row["a16_ms"],
         "cublas_bf16_ms": q8row["cublas_bf16_ms"],
         "bound_ms": q8row["bound_ms"], "bound_by": q8row["bound_by"],
         "timed": "M=32, K=2048, N=8192 (fc1 of CaptionerConfig.large()), "
                  "20 copies of the weights in turn"},
        {"name": "flash_bwd_delta", "route": "cuda", "source": bwd_src,
         "replaces": bwd_site, "replaces_in_jax": jax_flash + ":273",
         "launches": inst["flash_bwd_delta"] + mid["flash_bwd_delta"],
         "max_abs_err": max(r["delta_err"] for r in bwd_rows.values()),
         "ms": brow["delta_ms"], "plain_ms": brow["plain_delta_ms"],
         "library_ms": None, **brow["bound"]["delta"], "timed": bwd_timed},
        {"name": "flash_bwd_fused", "route": "cuda", "source": bwd_src,
         "replaces": bwd_site,
         "replaces_in_jax": jax_flash + ":1121 and :1456",
         "launches": inst["flash_bwd_fused"] + mid["flash_bwd_fused"],
         "max_abs_err": max(r["max_abs_err"] for r in bwd_rows.values()),
         "max_rel_fro": max(r["rel_fro"] for r in bwd_rows.values()),
         "ms": brow["fused_ms"], "plain_ms": brow["plain_bwd_ms"],
         "library_ms": brow["library_bwd_ms"],
         "library_kernels": brow["library_kernels"],
         **brow["bound"]["fused"],
         "backward_ms": brow["bwd_ms"],
         "backward_bound_ms": brow["bound"]["bwd"]["bound_ms"],
         "timed": bwd_timed + "; dk, dv and dq (added into a float32 "
                  "accumulator) in one pass of 5 products; plain_ms and "
                  "library_ms are of the whole backward: attention_bwd_ref, "
                  "and SDPA's forward + backward less its forward; "
                  "backward_ms is delta + fused + convert"},
        {"name": "flash_bwd_dq_convert", "route": "cuda", "source": bwd_src,
         "replaces": bwd_site, "replaces_in_jax": jax_flash + ":1456",
         "launches": (inst["flash_bwd_dq_convert"]
                      + mid["flash_bwd_dq_convert"]),
         "max_abs_err": max(r["convert_err"] for r in bwd_rows.values()),
         "ms": brow["convert_ms"], "plain_ms": brow["plain_convert_ms"],
         "library_ms": None, **brow["bound"]["convert"],
         "timed": bwd_timed + "; dq = bf16(accumulator / sqrt(hd))"},
    ]}


def main() -> int:
    if sys.argv[1:2] == ["--cli"]:
        return cli_with_counts(sys.argv[2], sys.argv[3:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="",
                    help="development: run only these of phases 14,15,16 "
                         "(prints no kernels record and no ok line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 1
    sys.modules["tiktoken"] = None
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["VIDGRAPH_TORCH_DEVICE"] = "cuda"
    from vidgraph_tpu_torch.ops import _build
    from vidgraph_tpu_torch.ops import topk_cosine as tc

    from vidgraph_tpu_torch.core.platform import describe_device, device

    card = nvidia_smi()
    log(f"phase 1: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; {json.dumps(describe_device(device()))}")
    t0 = time.perf_counter()
    _build.library()
    log(f"phase 1: kernels built and loaded in "
        f"{time.perf_counter() - t0:.2f} s ({_build.library_path.name})")
    for line in _build.build_log().splitlines():
        if "entry function" in line:
            log("  ptxas:", line.split("'")[1][:160])
        elif "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())

    only = ({int(x) for x in args.phases.split(",")} if args.phases
            else None)
    if only is not None and not only <= {14, 15, 16}:
        ap.error("--phases takes 14, 15 and 16")
    if only is not None:
        # a partial run, for development: no kernels record, no ok line
        if 14 in only:
            phase_flash_backward(args.seed, card)
        if 15 in only:
            phase_training(args.seed, card)
        if 16 in only:
            phase_acs(card)
        assert "jax" not in sys.modules, "the port's run imported jax"
        log(f"phases {sorted(only)} done at {time.perf_counter() - t0:.1f} s "
            f"(partial run)")
        return 0
    kern = phase_kernels(tc, args.seed, card)
    main_path = phase_main_path(tc, args.seed)
    phase_cli()
    flash = phase_flash(args.seed, card)
    chat = phase_chat_lm(args.seed)
    logits = phase_prefill_logits(args.seed)
    log(f"phases 1-8 done at {time.perf_counter() - t0:.1f} s")
    pre = phase_preprocess(args.seed, card)
    short = phase_short_attention(args.seed, card)
    vision = phase_vision(args.seed, card)
    log(f"phases 1-11 done at {time.perf_counter() - t0:.1f} s")
    q8k = phase_q8_matmul(args.seed, card)
    quant = phase_quantized(args.seed, card)
    log(f"phases 1-13 done at {time.perf_counter() - t0:.1f} s")
    bwd = phase_flash_backward(args.seed, card)
    training = phase_training(args.seed, card)
    acs = phase_acs(card)
    log(f"phases 1-16 done at {time.perf_counter() - t0:.1f} s")
    assert "jax" not in sys.modules, "the port's run imported jax"
    record = kernel_record(kern, main_path, flash, chat, pre, short, vision,
                           q8k, quant, bwd, training)
    record.update({
        "topk_b16_k5_ms": kern["times"]["topk_b16_k5"],
        "retrieval_p50_ms": main_path["p50_ms"],
        "retrieval_p95_ms": main_path["p95_ms"],
        "flash_ms": flash, "chat_lm": chat, "prefill_logits": logits,
        "preprocess_ms": pre, "short_attention_ms": short,
        "vision": vision, "q8_matmul_ms": q8k, "quantized": quant,
        "flash_backward": bwd, "training": training, "acs": acs})
    print(json.dumps(record))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
