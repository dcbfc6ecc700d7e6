"""Time the kernels of two trees of the PyTorch port in turns, on one
CUDA card.

    python3 scripts/compare_torch_kernels.py --parent DIR [--train]
        [--int8-decode] [--rounds 2]
        [--jobs cosine,flash_fwd,short_attention,flash_bwd,q8,preprocess,
                plans,general_attention,decode_attention]

``DIR`` holds another commit of this repository (for example
``git archive <commit> | tar -x -C DIR``, in a directory ``.gitignore``
lists).  Kernel times spread about 7 % between calls to a card, so two
versions are compared only within one process tree on one card: the
script runs the parent, this tree, this tree, the parent (``--rounds``
pairs), each in a fresh process that imports that tree's
``vidgraph_tpu_torch`` and builds its kernels into that tree's
``build/kernels``.  The shapes, checks and yardsticks are this tree's
``chip_smoke.py``'s; each process prints one JSON line with the jobs
named by ``--jobs`` (the first four by default):

* ``cosine``: phase 2's top-5 of the 200,000 x 512 float32 store at B 1
  and 16 and its dense scores at B 16, top-100 and top-1000 at B 1 and 16
  on that store in float32 and bfloat16, and phase 17's top-3 of a
  stream's memory (300 of 1,024 rows), each held to the plain version
  (``TOL``): CUDA-event medians of a call and device times from CUDA-graph
  replay (``graph_ms``), with the library calls (``torch.topk`` over masked
  ``F.normalize(q) @ S.T``, and that product alone) beside them; and the
  host's microseconds a search (200 calls enqueued on the small store),
  with a new row count each call (a new tensor map), and the host calls
  that the top-k path once made a search (the SM count, the launch's
  query limit, the merge's launch);
* ``flash_fwd``: the forward at phase 6's serving shapes (B 1, 8, 32 x T
  2056 x 8 heads x 64, and 1 x 2056 x 16 x 128; SDPA beside) and with its
  log-sum-exp at phase 14's three training shapes, each held to
  ``attention_ref`` (and ``lse_ref``) first;
* ``short_attention``: ``chip_smoke.py::phase_short_attention`` (phase 10:
  B 1, 5, 160 x 12 heads x N 50 x hd 64 bf16 and the ViT's strided views,
  each held to the plain version, then device times of the kernel, the
  plain version and SDPA);
* ``flash_bwd``: ``_cuda_flash_bwd`` (every backward launch) at phase 14's
  timed training shapes (``BWD_SHAPES[:BWD_TIMED]``): CUDA-event medians,
  and ``library_sdpa_train`` (SDPA's backward under autograd) beside it.

* ``q8``: phase 12's w8a16 products (the eight block matrices of
  ``large()`` and ``base()``, checked at ``Q8_CHECK_M`` rows), device time
  at M 1, 8, 32 over 20 rotating weight copies with float32 out (every
  tree's signature), the wrapper's host time a call, cuBLAS bf16 beside;
  bfloat16 out where the tree takes ``out_dtype``;
* ``preprocess``: phase 9's frames (5 and 160 of 405 x 720 -> 224, fast
  and exact, 224^2, 120 x 160) and phase 21's 160 frames of 720 x 1280
  (fast), each checked first, device time from CUDA-graph replay and the
  CUDA-event median of a call;
* ``plans``: the preprocessing kernel under each of its two block plans
  (``ops/preprocess.py::full_plan``, bands of whole source rows, and
  ``strip_plan``, bands x strips of output columns) at 5 and 160 frames
  of 1080 x 1920, 1081 x 1921 and 1440 x 2560 -> 224, fast and exact,
  where both fit the card: each held to the plain version, device time
  from CUDA-graph replay, the plan ``plan`` picks and each plan's shape.
  A tree with one plan reports none;
* ``general_attention``: phase 26's cells of the general kernels
  (``csrc/attention_general*.cu``): ``chip_smoke.py::general_flash_row``
  at ``ATTN_DOMAIN_FLASH`` in float32 and bfloat16 and at its last shape
  in float16 (the forward, its log-sum-exp and the three gradients held
  to the plain versions, then CUDA-event medians of the forward, the
  forward with lse and the backward's three launches, their device times
  from CUDA-graph replay, the plain versions and SDPA forward and
  backward), and ``general_short_row`` at ``ATTN_DOMAIN_SHORT`` (held to
  the plain version, then device times of the kernel, the plain version
  and SDPA);
* ``decode_attention``: one decode step's attention at ``DECODE_SHAPES``
  (``large()`` at B 1, 64 and 512 x 265 slots, ``base()`` at B 16,
  ``chat()`` at B 1 x 4,096 and x 1,200), at the last and the middle slot: device
  time (CUDA-graph replay) and the host's microseconds a call of the
  eager chain that ``_step_block`` ran before ``ops/decode_attention.py``
  (the qkv bias add and the twelve ops of the attention), SDPA at
  q-length 1 with a boolean mask beside it, and the kernel (checked
  first; its route, device time, CUDA-event median, host time) where the
  tree has it; below the SM count of (row, head) pairs, the kernel's
  device time on its single route and on its split route apart.

``--train`` also runs each tree's ``scripts/profile_torch_train_step.py``
(instruct and mid-scale steps with ``--flash``) in the same order, and
``--int8-decode`` each tree's ``scripts/profile_torch_int8_decode.py
--scale large --batches 8 32`` (ms/step, launches a step, busy share of
the four int8 modes).  The card's name
and power limit head the output.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn``: ``calls`` calls enqueued
    without a synchronisation (the device's work is short beside it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def cosine_job(smoke) -> dict:
    """Phase 2's timed calls at 200,000 x 512, the selection's k at float32
    and bfloat16, phase 17's stream memory, each checked first; the host
    time of a search."""
    import numpy as np
    import torch

    from vidgraph_tpu_torch.core.profiling import cuda_ms, graph_ms
    from vidgraph_tpu_torch.ops import _build
    from vidgraph_tpu_torch.ops import topk_cosine as tc

    rng = np.random.default_rng(0)
    host = rng.normal(size=(smoke.STORE_ROWS, smoke.DIM)).astype(np.float32)
    host /= np.linalg.norm(host, axis=1, keepdims=True)
    store = torch.from_numpy(host).cuda()
    queries = torch.from_numpy(
        rng.normal(size=(16, smoke.DIM)).astype(np.float32)).cuda()
    count = smoke.STORE_COUNT
    past = torch.arange(smoke.STORE_ROWS, device="cuda") >= count
    rows = {}

    def topk_row(q, st, k, n_count, mask):
        return {
            "max_abs_err": smoke.check_topk(tc, q, st, k, n_count),
            "kernel_ms": cuda_ms(lambda: tc.cosine_topk(q, st, k,
                                                        count=n_count)),
            "device_ms": graph_ms(lambda: tc.cosine_topk(q, st, k,
                                                         count=n_count)),
            "library_ms": cuda_ms(
                lambda: smoke.library_topk(q, st, mask, k))}

    for b in (1, 16):
        rows[f"topk_b{b}_k5"] = topk_row(queries[:b], store, 5, count, past)
    dense = tc.cosine_scores(queries, store, count=count)
    torch.cuda.synchronize()
    err = float((dense - tc.cosine_scores_ref(queries, store, count=count))
                .abs().max())
    assert err <= smoke.TOL, f"dense score error {err}"
    rows["dense_b16"] = {
        "max_abs_err": err,
        "kernel_ms": cuda_ms(lambda: tc.cosine_scores(queries, store,
                                                      count=count)),
        "device_ms": graph_ms(lambda: tc.cosine_scores(queries, store,
                                                       count=count)),
        "library_ms": cuda_ms(
            lambda: smoke.library_scores(queries, store, past))}
    del dense
    for name, st in (("f32", store), ("bf16", store.to(torch.bfloat16))):
        for k in (100, 1000):
            for b in (1, 16):
                rows[f"topk_{name}_b{b}_k{k}"] = topk_row(
                    queries[:b], st, k, count, past)
    # phase 17's stream memory: top-3 of the first 300 of 1,024 rows
    small = store[:1024].contiguous()
    small_past = torch.arange(1024, device="cuda") >= 300
    rows["stream_b1_k3_rows300"] = topk_row(queries[:1], small, 3, 300,
                                            small_past)
    q1 = queries[:1]
    lib = _build.library()
    counts = iter(range(10 ** 6))
    hosts = {
        "topk_b1_k5": host_us(lambda: tc.cosine_topk(q1, small, 5,
                                                     count=1000)),
        "topk_b16_k5": host_us(lambda: tc.cosine_topk(queries, small, 5,
                                                      count=1000)),
        "topk_b1_k5_new_count": host_us(lambda: tc.cosine_topk(
            q1, small, 5, count=900 + next(counts) % 100)),
        "topk_b16_k100": host_us(lambda: tc.cosine_topk(queries, small, 100,
                                                        count=1000)),
        "sm_count": host_us(lambda: torch.cuda.get_device_properties(
            store.device).multi_processor_count),
        "queries_per_launch": host_us(
            lambda: lib.cosine_queries_per_launch(smoke.DIM, 5, 0))}
    if hasattr(tc, "topk_merge"):         # a tree with the merge kernel
        pv, pi = tc.topk_partials(q1, small, 5, 1000)
        hosts["merge_launch"] = host_us(lambda: tc.topk_merge(pv, pi, 5))
    rows["host_us"] = hosts
    return rows


def flash_fwd_job(smoke) -> dict:
    """The forward at phase 6's T = 2056 shapes and phase 14's timed
    training shapes (with the log-sum-exp), each checked first."""
    import numpy as np
    import torch

    from vidgraph_tpu_torch.core.profiling import cuda_ms
    from vidgraph_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(2)
    shapes = [(b, t, h, hd, 8, False) for b, t, h, hd in smoke.FLASH_SHAPES
              if t == 2056]
    shapes += [(b, t, h, hd, nv, True)
               for b, t, h, hd, nv in smoke.BWD_SHAPES[:smoke.BWD_TIMED]]
    rows = {}
    for b, t, h, hd, nv, with_lse in shapes:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, t, h, hd), dtype=np.float32)).to("cuda", torch.bfloat16)
            for _ in range(3))
        out, lse = fa._cuda_flash(q, k, v, nv, with_lse=with_lse)
        torch.cuda.synchronize()
        err = excess = lse_err = 0.0
        for i in range(b):                  # the plain version row by row
            ref = fa.attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                   nv).to(torch.bfloat16).float()
            diff = (out[i:i + 1].float() - ref).abs()
            err = max(err, float(diff.max()))
            excess = max(excess, float(
                (diff - fa.TOL_ABS - fa.TOL_REL * ref.abs()).max()))
            if with_lse:
                lse_err = max(lse_err, float((lse[i] - fa.lse_ref(
                    q[i:i + 1], k[i:i + 1], nv)[0]).abs().max()))
        assert excess <= 0 and lse_err <= 2e-3, (b, t, h, hd, err, lse_err)
        row = {"max_abs_err": err, "kernel_ms": cuda_ms(
            lambda: fa._cuda_flash(q, k, v, nv, with_lse=with_lse))}
        if with_lse:
            row["lse_err"] = lse_err
        if not with_lse:
            row["library_ms"] = smoke.library_sdpa(
                q, k, v, fa.prefix_causal_mask(t, nv, q.device))["library_ms"]
        rows[f"b{b}_T{t}_h{h}x{hd}" + ("_lse" if with_lse else "")] = row
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    return rows


def flash_bwd_job(smoke) -> dict:
    """The backward at phase 14's timed training shapes, SDPA beside."""
    import numpy as np
    import torch

    from vidgraph_tpu_torch.core.profiling import cuda_ms
    from vidgraph_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(0)
    bwd = {}
    for b, t, h, hd, nv in smoke.BWD_SHAPES[:smoke.BWD_TIMED]:
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (b, t, h, hd), dtype=np.float32)).to("cuda", torch.bfloat16)
            for _ in range(4))
        out, lse = fa._cuda_flash(q, k, v, nv, with_lse=True)
        row = {"bwd_ms": cuda_ms(lambda: fa._cuda_flash_bwd(
            q, k, v, out, lse, do, nv))}
        row.update(smoke.library_sdpa_train(
            q, k, v, do, fa.prefix_causal_mask(t, nv, q.device)))
        bwd[f"b{b}_T{t}_h{h}x{hd}_nv{nv}"] = row
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return bwd


def q8_job(smoke) -> dict:
    """Phase 12: the w8a16 product at the eight block matrices of large()
    and base(), held to the plain version at ``Q8_CHECK_M`` rows (two runs
    equal), then at M 1, 8, 32 the device time a call over 20 rotating
    copies of the weights, float32 out as every tree takes it, the
    wrapper's host time a call, and cuBLAS bf16 ``x @ w`` beside it; the
    bfloat16-out time where the tree's ``q8_matmul`` takes ``out_dtype``."""
    import inspect

    import numpy as np
    import torch

    from vidgraph_tpu_torch.core.profiling import graph_ms
    from vidgraph_tpu_torch.models import quant8
    from vidgraph_tpu_torch.ops import q8_matmul as q8

    bf16 = torch.bfloat16
    has_out = "out_dtype" in inspect.signature(q8.q8_matmul).parameters
    rng = np.random.default_rng(5)
    rows = {}
    for k, n in smoke.Q8_SHAPES:
        w = torch.from_numpy(rng.standard_normal(
            (k, n), dtype=np.float32) * 0.02).cuda()
        wq = quant8.quantize_matrix(w)
        for m in smoke.Q8_CHECK_M:
            x = torch.from_numpy(rng.standard_normal(
                (m, k), dtype=np.float32)).to("cuda", bf16)
            smoke.check_q8(q8, x, wq.q, wq.s)
        qs = [wq.q.clone() for _ in range(smoke.Q8_COPIES)]
        ws = [w.to(bf16) for _ in range(smoke.Q8_COPIES)]
        s = wq.s
        for m in (1, 8, 32):
            x = torch.from_numpy(rng.standard_normal(
                (m, k), dtype=np.float32)).to("cuda", bf16)
            row = {"kernel_ms": graph_ms(smoke.rotating(
                       lambda q: q8.q8_matmul(x, q, s), qs)),
                   "host_us": smoke.host_us(
                       lambda: q8.q8_matmul(x, qs[0], s)),
                   "cublas_bf16_ms": graph_ms(smoke.rotating(
                       lambda v: x @ v, ws))}
            if has_out:
                row["kernel_bf16_out_ms"] = graph_ms(smoke.rotating(
                    lambda q: q8.q8_matmul(x, q, s, bf16), qs))
            rows[f"K{k}_N{n}_M{m}"] = row
        del qs, ws, w, wq
        torch.cuda.empty_cache()
    return rows


def preprocess_job(smoke) -> dict:
    """Phase 9's shapes, each held to the plain version first: device time
    a call (20 calls replayed from a CUDA graph) and the CUDA-event median
    of one call."""
    import numpy as np
    import torch

    from vidgraph_tpu_torch.core.profiling import cuda_ms, graph_ms
    from vidgraph_tpu_torch.ops import preprocess as pre

    rng = np.random.default_rng(3)
    rows = {}
    for b, h, w, fast in [*smoke.PRE_SHAPES, (160, 720, 1280, True)]:
        x = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3),
                                          dtype=np.uint8)).cuda()
        got = pre.preprocess_frames(x, 224, fast)
        torch.cuda.synchronize()
        ref = pre.preprocess_ref(x, 224, fast)
        tol = pre.TOL_FAST if ref.dtype == torch.bfloat16 else pre.TOL_F32
        err = float((got.float() - ref.float()).abs().max())
        assert got.shape == ref.shape and err <= tol, (b, h, w, fast, err)
        rows[f"b{b}_{h}x{w}_{'fast' if fast else 'exact'}"] = {
            "max_abs_err": err,
            "kernel_ms": graph_ms(lambda: pre.preprocess_frames(x, 224,
                                                                fast)),
            "call_ms": cuda_ms(lambda: pre.preprocess_frames(x, 224, fast))}
        del x, got, ref
    return rows


def plans_job(smoke) -> dict:
    """Both block plans of the preprocessing kernel at frames where the
    planner picks between them, each held to the plain version first."""
    import numpy as np
    import torch

    from vidgraph_tpu_torch.core.profiling import graph_ms
    from vidgraph_tpu_torch.ops import preprocess as pre

    if not hasattr(pre, "strip_plan"):
        return {}
    rng = np.random.default_rng(0)
    rows = {}
    for h, w in [(1080, 1920), (1081, 1921), (1440, 2560)]:
        for b in (5, 160):
            x = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3),
                                              dtype=np.uint8)).cuda()
            for fast in (True, False):
                ref = pre.preprocess_ref(x[:5], 224, fast)
                tol = pre.TOL_FAST if fast else pre.TOL_F32
                row = {"chosen": "full" if pre.plan(
                    h, w, 224, fast, b).cols == 224 else "strip"}
                for name, strips, p in (
                        ("full", False, pre.full_plan(h, w, 224, fast, b)),
                        ("strip", True, pre.strip_plan(h, w, 224, fast))):
                    if p.smem > pre.SMEM_MAX:
                        continue
                    got = pre._cuda_preprocess(x, 224, fast, strips)
                    torch.cuda.synchronize()
                    err = float((got[:5].float() - ref.float()).abs().max())
                    assert err <= tol, (h, w, b, fast, name, err)
                    row[name] = {
                        "ms": graph_ms(lambda: pre._cuda_preprocess(
                            x, 224, fast, strips)),
                        "rows": p.rows, "cols": p.cols,
                        "source_rows": int(p.count.max()), "smem": p.smem}
                    del got
                rows[f"{h}x{w}_b{b}_{'fast' if fast else 'exact'}"] = row
            del x
    return rows


def general_attention_job(smoke) -> dict:
    """Phase 26's general-route cells, each held to its plain version
    first (``general_flash_row``, ``general_short_row``)."""
    import numpy as np
    import torch

    from vidgraph_tpu_torch.ops import flash_attention as fa
    from vidgraph_tpu_torch.ops import short_attention as sa

    rng = np.random.default_rng(26)
    cells = [(*shape, dtype) for shape in smoke.ATTN_DOMAIN_FLASH
             for dtype in (torch.float32, torch.bfloat16)]
    cells.append((*smoke.ATTN_DOMAIN_FLASH[-1], torch.float16))
    rows = {}
    for b, t, h, hd, dtype in cells:
        row = smoke.general_flash_row(fa, b, t, h, hd, dtype, rng)
        row.pop("library_kernels", None)
        rows[f"flash_b{b}_T{t}_h{h}x{hd}_{str(dtype)[6:]}"] = row
    for name, b, h, n, hd, dtype in smoke.ATTN_DOMAIN_SHORT:
        rows[f"short_{name}"] = smoke.general_short_row(sa, b, h, n, hd,
                                                        dtype, rng)
    return rows


# (name, B, h, hd, max_t): the decode steps of large() at B 1 (the ingest
# cell), 64 and 512, base() at B 16 and chat() at B 1 over 4,096 and over
# 1,200 positions (601 live keys at the middle slot: near where ``plan``
# turns to the split route)
DECODE_SHAPES = (("large_b1", 1, 16, 128, 265), ("base_b16", 16, 8, 64, 265),
                 ("chat_b1", 1, 8, 64, 4096), ("chat_b1_1200", 1, 8, 64, 1200),
                 ("large_b64", 64, 16, 128, 265),
                 ("large_b512", 512, 16, 128, 265))


def decode_routes(da, kernel, bh: int, live: int, hd: int) -> dict:
    """Device time of ``kernel`` on each route where ``plan`` could take
    either (fewer (row, head) pairs than SMs): the single route, one block
    a pair, and the split that ``plan`` makes when it splits."""
    from vidgraph_tpu_torch.core.profiling import graph_ms

    plan, min_keys = da.plan, da.SPLIT_MIN_KEYS
    try:
        da.SPLIT_MIN_KEYS = 0
        split = plan(bh, live, hd, da._sm_count(0))
    finally:
        da.SPLIT_MIN_KEYS = min_keys
    out = {"split_route": list(split)}
    for name, route in (("single", (1, live)), ("split", split)):
        if route[0] == 1 and name == "split":
            continue
        da.plan = lambda *_: route
        try:
            out[name + "_device_ms"] = graph_ms(kernel)
        finally:
            da.plan = plan
    return out


def decode_attention_job(smoke) -> dict:
    """The decode step's attention at ``DECODE_SHAPES``, every key up to
    the last slot live, and at the middle slot (the average step): the
    eager chain that the parent runs, the qkv bias add and twelve ops
    (device time from CUDA-graph replay, host microseconds a call
    enqueued), SDPA at q-length 1 with a boolean mask (float32, the
    caches' type; the cache writes left out), and, where the tree has
    ``ops/decode_attention.py``, the kernel, checked against the chain
    first.  ``bound_ms``: the live K and
    V, q and o over 3.35 TB/s."""
    import math

    import torch
    import torch.nn.functional as F

    from vidgraph_tpu_torch.core.profiling import cuda_ms, graph_ms
    try:
        from vidgraph_tpu_torch.ops import decode_attention as da
    except ImportError:
        da = None
    dt = torch.bfloat16
    rows = {}
    for name, b, h, hd, max_t in DECODE_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(b * max_t)
        raw = torch.randn(b, 1, 3 * h * hd, generator=g,
                          device="cuda").to(dt)
        bias = torch.randn(3 * h * hd, generator=g, device="cuda").to(dt)
        q_raw, k_raw, v_raw = (z.reshape(b, 1, h, hd)
                               for z in raw.split(h * hd, -1))
        qf = (raw + bias)[..., :h * hd].reshape(b, 1, h, hd).float() \
            .transpose(1, 2)
        kc, vc = (torch.randn(b, h, max_t, hd, generator=g, device="cuda")
                  for _ in range(2))
        for where, slot in (("last", max_t - 1), ("mid", max_t // 2)):
            live = slot + 1
            key = torch.arange(max_t, device="cuda")
            masked = (key > slot)[None, None, None, :].expand(
                b, 1, 1, max_t).contiguous()
            seen = ~masked

            def chain():
                q, k, v = (z.reshape(b, 1, h, hd)
                           for z in (raw + bias).split(h * hd, -1))
                kc[:, :, slot] = k[:, 0]
                vc[:, :, slot] = v[:, 0]
                att = (q.float().transpose(1, 2) @ kc.transpose(2, 3)) \
                    / math.sqrt(hd)
                att = att.masked_fill(masked, -1e30)
                att = torch.softmax(att, dim=-1).to(dt)
                o = (att.float() @ vc).transpose(1, 2)
                return o.reshape(b, 1, -1).to(dt)

            def sdpa():
                return F.scaled_dot_product_attention(qf, kc, vc,
                                                      attn_mask=seen)

            row = {"live": live,
                   "bound_ms": (2 * live * hd * 4 + 2 * hd * 2) * b * h
                   / 3.35e9,
                   "plain_device_ms": graph_ms(chain),
                   "plain_host_us": host_us(chain),
                   "library_sdpa_device_ms": graph_ms(sdpa)}
            if da is not None:
                def kernel():
                    return da.decode_attention(q_raw, k_raw, v_raw, bias,
                                               kc, vc, slot, masked, dt)
                want = chain()
                got = kernel()
                row["max_abs_err"] = float((got.float() - want.float())
                                           .abs().max())
                row["route"] = da.plan(b * h, live, hd,
                                       da._sm_count(0))
                row["kernel_device_ms"] = graph_ms(kernel)
                row["kernel_ms"] = cuda_ms(kernel)
                row["kernel_host_us"] = host_us(kernel)
                if b * h < da._sm_count(0):
                    row.update(decode_routes(da, kernel, b * h, live, hd))
            rows[f"{name}_{where}"] = row
        del kc, vc
        torch.cuda.empty_cache()
    return rows


JOBS = {"cosine": cosine_job, "flash_fwd": flash_fwd_job,
        "short_attention": lambda smoke: smoke.phase_short_attention(
            0, smoke.nvidia_smi()),
        "flash_bwd": flash_bwd_job, "q8": q8_job,
        "preprocess": preprocess_job, "plans": plans_job,
        "general_attention": general_attention_job,
        "decode_attention": decode_attention_job}
DEFAULT_JOBS = ("cosine", "flash_fwd", "short_attention", "flash_bwd")


def worker(root: Path, jobs) -> dict:
    sys.path.insert(0, str(root))
    import torch

    smoke = load_smoke()
    from vidgraph_tpu_torch.ops import _build
    from vidgraph_tpu_torch.ops import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    rec = {"tree": str(root), "build_s": time.perf_counter() - t0}
    for job in jobs:
        rec[job] = JOBS[job](smoke)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--int8-decode", action="store_true")
    ap.add_argument("--jobs", default=",".join(DEFAULT_JOBS))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    jobs = [j for j in args.jobs.split(",") if j]
    unknown = set(jobs) - set(JOBS)
    if unknown:
        ap.error(f"unknown jobs {sorted(unknown)}; known: {sorted(JOBS)}")
    if args.worker:
        print(json.dumps(worker(Path(args.worker), jobs)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_torch_kernels: no CUDA card", file=sys.stderr)
        return 1
    if not args.parent:
        ap.error("--parent DIR is required")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    parent = Path(args.parent).resolve()
    order = []
    for _ in range(args.rounds):
        order += [("parent", parent), ("change", ROOT), ("change", ROOT),
                  ("parent", parent)]
    order = order[:2 * args.rounds]
    status = 0
    for label, root in order:
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(root), "--jobs", ",".join(jobs)], capture_output=True,
            text=True, cwd=root)
        status |= res.returncode
        line = res.stdout.strip().splitlines()[-1:] or [res.stderr[-2000:]]
        print(f"{label}: {line[0]}", flush=True)
    scripts = []
    if args.train:
        scripts.append(("train", ["profile_torch_train_step.py"]))
    if args.int8_decode:
        scripts.append(("int8 decode", [
            "profile_torch_int8_decode.py", "--scale", "large",
            "--batches", "8", "32"]))
    for name, cmd in scripts:
        for label, root in order:
            res = subprocess.run(
                [sys.executable, str(root / "scripts" / cmd[0]), *cmd[1:]],
                capture_output=True, text=True, cwd=root)
            status |= res.returncode
            for line in res.stdout.strip().splitlines():
                print(f"{label} {name}: {line}", flush=True)
            if res.returncode:
                print(res.stderr[-2000:], flush=True)
    return status


if __name__ == "__main__":
    raise SystemExit(main())
