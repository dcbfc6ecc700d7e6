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
   with ``config/high_recall_config.yaml`` and NetworkX ACS.

The last three lines: the kernels' JSON record, the card's name and power
limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or outside a checkout, it exits nonzero and prints no result.
``tiktoken`` is kept out of every phase: its encoder would be fetched over
the network; without it the token splitter uses its calibrated estimator.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
STORE_ROWS, STORE_COUNT, DIM = 200_000, 199_937, 512
_TIKTOKEN_BLOCK = ('raise ImportError("tiktoken is kept out of this run: its '
                   'encoder would be fetched over the network")\n')


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
            "kernel_ms": median_ms(
                lambda: tc.cosine_topk(q, store, 5, count=STORE_COUNT)),
            "plain_ms": median_ms(
                lambda: tc.cosine_topk_ref(q, store, 5, count=STORE_COUNT)),
            # context, not the plain version: an unordered-ties top-k
            "matmul_topk_ms": median_ms(lambda: torch.topk(
                tc.cosine_scores_ref(q, store, count=STORE_COUNT), 5)),
        }
    q = queries[:16]
    times["dense_b16"] = {
        "kernel_ms": median_ms(
            lambda: tc.cosine_scores(q, store, count=STORE_COUNT)),
        "plain_ms": median_ms(
            lambda: tc.cosine_scores_ref(q, store, count=STORE_COUNT)),
    }
    stages = time_topk_stages(tc, queries[:16], store)
    log(f"phase 2 times on {card} (median of 20, ms) at 200,000 x 512 f32:",
        json.dumps(times), json.dumps(stages))
    return {"topk_err": topk_err, "score_err": score_err, "times": times,
            "stages": stages}


def time_topk_stages(tc, q, store, k: int = 5) -> dict:
    """Each kernel of the top-k apart, at B=16, k=5: ``cosine_score_tile``
    in top-k mode (per-tile partials) and ``cosine_topk_merge``, each
    checked against its own plain version on the same inputs."""
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
        "score_topk_b16_k5": {
            "kernel_ms": median_ms(
                lambda: tc.topk_partials(q, store, k, STORE_COUNT)),
            "plain_ms": median_ms(
                lambda: tc.topk_partials_ref(q, store, k, STORE_COUNT, tile)),
            "max_abs_err": partial_err},
        "merge_b16_k5": {
            "kernel_ms": median_ms(lambda: tc.topk_merge(pv, pi, k)),
            "plain_ms": median_ms(lambda: tc.topk_merge_ref(pv, pi, k)),
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
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
        if "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())

    kern = phase_kernels(tc, args.seed, card)
    main_path = phase_main_path(tc, args.seed)
    phase_cli()
    assert "jax" not in sys.modules, "the port's run imported jax"

    src = "vidgraph_tpu_torch/csrc/topk_cosine.cu"
    replaces = "vidgraph_tpu/ops/topk_cosine.py:39"
    launches = main_path["launches"]
    stages = kern["stages"]
    dense = kern["times"]["dense_b16"]
    record = {"kernels": [
        {"name": "cosine_score_tile (top-k mode)", "route": "cuda",
         "source": src, "replaces": replaces,
         "launches": launches["score_topk"],
         "max_abs_err": stages["score_topk_b16_k5"]["max_abs_err"],
         "ms": stages["score_topk_b16_k5"]["kernel_ms"],
         "plain_ms": stages["score_topk_b16_k5"]["plain_ms"],
         "timed": "per-tile top-5 partials, B=16, 200000x512 f32"},
        {"name": "cosine_topk_merge", "route": "cuda", "source": src,
         "replaces": replaces, "launches": launches["merge"],
         "max_abs_err": stages["merge_b16_k5"]["max_abs_err"],
         "ms": stages["merge_b16_k5"]["kernel_ms"],
         "plain_ms": stages["merge_b16_k5"]["plain_ms"],
         "timed": "merge of 782 tiles' top-5 partials, B=16"},
        {"name": "cosine_score_tile (dense mode)", "route": "cuda",
         "source": src, "replaces": replaces,
         "launches": launches["score_dense"],
         "max_abs_err": kern["score_err"], "ms": dense["kernel_ms"],
         "plain_ms": dense["plain_ms"],
         "timed": "dense scores, B=16, 200000x512 f32"},
    ], "topk_b16_k5_ms": kern["times"]["topk_b16_k5"],
        "retrieval_p50_ms": main_path["p50_ms"],
        "retrieval_p95_ms": main_path["p95_ms"]}
    print(json.dumps(record))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
