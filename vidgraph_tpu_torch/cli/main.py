"""CLI of the PyTorch port, run as ``python -m vidgraph_tpu_torch.cli.main``.

The parser is ``vidgraph_tpu/cli/main.py``'s.  Ported: ``kg`` (with
``--resume-uuid``), ``retrieve``, ``ask``, ``batch-retrieve``, ``export``,
``import`` and ``benchmark``.  ``vlm``, ``graph``, ``stream``, ``serve`` and
``prune`` exit with status 2 and name the ROADMAP slice that ports them.

CLI — surface parity with the reference (reference:
src/cli/main.py:187-289): subcommands ``vlm`` (plus ``graph`` alias — the
reference README documented ``graph`` while the parser registered ``vlm``),
``kg``, ``retrieve``, ``batch-retrieve``, ``export``, ``import``,
``benchmark``; identical flags; ``batch-retrieve`` also writes
``metrics/retrieval_times_{uuid}_{timestamp}.json`` with per-query and
average times.
"""
from __future__ import annotations

import argparse
import asyncio
import datetime as _dt
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

from ..core.config import PipelineConfig
from ..core.logger import get_logger

logger = get_logger("cli")

NOT_PORTED = {"vlm": "slice 5, on-device vision",
              "graph": "slice 5, on-device vision",
              "stream": "slice 8, streams and serving",
              "serve": "slice 8, streams and serving",
              "prune": "the prune module, after vision"}


# ----------------------------------------------------------------- runners
async def run_kg_construction(config_path: str, vlm_output: str,
                              retrieval_schedule: Optional[str] = None,
                              resume_uuid: Optional[str] = None):
    from ..pipeline.kg_builder import KGBuilder

    config = PipelineConfig.from_yaml(config_path)
    builder = KGBuilder(config, run_uuid=resume_uuid,
                        load_existing=resume_uuid is not None)
    return await builder.build_knowledge_graph(
        vlm_output, retrieval_schedule, resume=resume_uuid is not None)


async def run_offline_retrieval(config_path: str, graph_uuid: str,
                                query: str, groundtruth: Optional[str],
                                true_chunks: Optional[List[int]]):
    from ..pipeline.retriever import OfflineRetriever

    config = PipelineConfig.from_yaml(config_path)
    retriever = OfflineRetriever(config, graph_uuid)
    try:
        result = await retriever.retrieve(query, groundtruth or "",
                                          true_chunks)
        print(result["retrieval"])
        return f"{result['retrieval_time']:.3f}s"
    finally:
        retriever.close()


async def run_ask(config_path: str, graph_uuid: str, query: str):
    """Retrieve + answer in one shot (new convenience command — the
    reference required retrieve -> benchmark round-trips through files)."""
    from ..pipeline.retriever import OfflineRetriever
    from ..services.llm_client import extractive_answer

    config = PipelineConfig.from_yaml(config_path)
    retriever = OfflineRetriever(config, graph_uuid)
    try:
        result = await retriever.retrieve(query, "", None)
        answer = extractive_answer(query, result["retrieval"])
        print(answer)
        return f"{result['retrieval_time']:.3f}s"
    finally:
        retriever.close()


async def run_batch_offline_retrieval(config_path: str, graph_uuid: str,
                                      input_path: str, output_path: str):
    from ..pipeline.retriever import OfflineRetriever

    config = PipelineConfig.from_yaml(config_path)
    retriever = OfflineRetriever(config, graph_uuid)
    try:
        t0 = time.perf_counter()
        results = await retriever.batch_retrieve_from_file(input_path,
                                                           output_path)
        total = time.perf_counter() - t0
        # retrieval-times metrics file (reference: src/cli/main.py:91-125)
        times = [r["retrieval_time"] for r in results]
        ts = _dt.datetime.now(_dt.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
        metrics_path = Path(f"metrics/retrieval_times_{graph_uuid}_{ts}.json")
        metrics_path.parent.mkdir(parents=True, exist_ok=True)
        metrics_path.write_text(json.dumps({
            "graph_uuid": graph_uuid,
            "total_queries": len(results),
            "total_time": total,
            "average_time": (sum(times) / len(times)) if times else 0.0,
            "per_query_times": [
                {"query": r["query"], "time": r["retrieval_time"]}
                for r in results],
        }, indent=2))
        logger.info("Saved retrieval timing metrics to %s", metrics_path)
        return output_path
    finally:
        retriever.close()


async def run_export_graph(config_path: str, graph_uuid: str,
                           output_path: str):
    from ..graph import GraphExporter, open_graph_store

    config = PipelineConfig.from_yaml(config_path)
    store = open_graph_store(config, graph_uuid)
    try:
        return GraphExporter(store).export_graph(output_path)
    finally:
        store.close()


async def run_import_graph(config_path: str, input_path: str,
                           new_uuid: Optional[str]):
    from ..graph import GraphImporter, open_graph_store

    config = PipelineConfig.from_yaml(config_path)
    importer = GraphImporter(
        lambda u: open_graph_store(config, u, load_existing=False))
    return importer.import_graph(input_path, new_uuid=new_uuid,
                                 use_new_uuid=new_uuid is None)


async def run_benchmark(config_path: str, input_path: str,
                        output_path: str):
    from ..pipeline.benchmark import BenchmarkEvaluator

    config = PipelineConfig.from_yaml(config_path)
    out = await BenchmarkEvaluator(config).evaluate_retrieval_results(
        input_path, output_path)
    acc = out["statistics"].get("accuracy", 0.0)
    return f"accuracy={acc:.4f} -> {output_path}"


# --------------------------------------------------------------------- parser
def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="vidgraph",
        description="vidgraph-tpu: TPU-native video-to-knowledge-graph "
                    "pipeline")
    sub = parser.add_subparsers(dest="command", help="Available commands")

    for name in ("vlm", "graph"):   # 'graph' is the documented alias
        p = sub.add_parser(name, help="Run VLM extraction on a video")
        p.add_argument("--config", required=True)
        p.add_argument("--video", required=True)
        p.add_argument("--output", required=True)

    p = sub.add_parser("kg", help="Build knowledge graph from VLM output")
    p.add_argument("--config", required=True)
    p.add_argument("--vlm-output", required=True)
    p.add_argument("--retrieval-schedule")
    p.add_argument("--resume-uuid",
                   help="Resume an interrupted build at its next batch")

    p = sub.add_parser("retrieve", help="Run offline retrieval")
    p.add_argument("--config", required=True)
    p.add_argument("--graph-uuid", required=True)
    p.add_argument("--query", required=True)
    p.add_argument("--groundtruth")
    p.add_argument("--true_chunks", nargs="*")

    p = sub.add_parser("ask", help="Retrieve + answer a question in one "
                       "step (extractive answerer)")
    p.add_argument("--config", required=True)
    p.add_argument("--graph-uuid", required=True)
    p.add_argument("--query", required=True)

    p = sub.add_parser("batch-retrieve",
                       help="Run batch offline retrieval from JSON file")
    p.add_argument("--config", required=True)
    p.add_argument("--graph-uuid", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)

    p = sub.add_parser("export", help="Export a knowledge graph")
    p.add_argument("--config", required=True)
    p.add_argument("--graph-uuid", required=True)
    p.add_argument("--output", required=True)

    p = sub.add_parser("import", help="Import a knowledge graph")
    p.add_argument("--config", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--new-uuid")

    p = sub.add_parser("benchmark", help="Evaluate retrieval results")
    p.add_argument("--config", required=True)
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)

    p = sub.add_parser("prune", help="Prune redundant relations in an "
                                     "exported graph JSON")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--threshold", type=float, default=0.8)

    p = sub.add_parser("stream", help="Run the real-time multi-stream "
                                      "engine over video files")
    p.add_argument("--config", required=True)
    p.add_argument("--videos", required=True, nargs="+",
                   help="One video file per stream")
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--seconds", type=float, default=0.0,
                   help="Video-seconds to process (0 = full shortest video)")
    p.add_argument("--query", action="append", default=[],
                   help="'<time_s>:<stream_idx>:<text>' scheduled query; "
                        "repeatable")
    p.add_argument("--realtime", action="store_true",
                   help="Pace frames at --fps (default: max throughput)")
    p.add_argument("--live-kg", action="store_true",
                   help="Build knowledge graphs per stream during ingest")

    p = sub.add_parser("serve", help="Serve the video-memory API over HTTP")
    p.add_argument("--config", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8077)
    return parser


def parse_true_chunks_args(parts: Optional[List[str]]
                           ) -> Optional[List[int]]:
    if not parts:
        return None
    flat: List[str] = []
    for part in parts:
        if isinstance(part, str) and "," in part:
            flat.extend(p.strip() for p in part.split(",") if p.strip())
        else:
            flat.append(part)
    try:
        return [int(x) for x in flat]
    except (ValueError, TypeError):
        logger.warning("Could not parse --true_chunks; ignoring")
        return None


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command in NOT_PORTED:
        print(f"vidgraph_tpu_torch: '{args.command}' is not yet ported "
              f"(ROADMAP: {NOT_PORTED[args.command]}); the JAX package "
              f"serves it: python -m vidgraph_tpu.cli.main {args.command}",
              file=sys.stderr)
        return 2
    if args.command == "kg":
        result = asyncio.run(run_kg_construction(args.config,
                                                 args.vlm_output,
                                                 args.retrieval_schedule,
                                                 args.resume_uuid))
        print(f"Knowledge graph construction completed with UUID: {result}")
    elif args.command == "retrieve":
        true_chunks = parse_true_chunks_args(args.true_chunks)
        result = asyncio.run(run_offline_retrieval(
            args.config, args.graph_uuid, args.query, args.groundtruth,
            true_chunks))
        print(f"Retrieval completed: {result}")
    elif args.command == "ask":
        result = asyncio.run(run_ask(args.config, args.graph_uuid,
                                     args.query))
        print(f"Answered in {result}")
    elif args.command == "batch-retrieve":
        result = asyncio.run(run_batch_offline_retrieval(
            args.config, args.graph_uuid, args.input, args.output))
        print(f"Batch retrieval completed: {result}")
    elif args.command == "export":
        result = asyncio.run(run_export_graph(args.config, args.graph_uuid,
                                              args.output))
        print(f"Graph export completed: {result}")
    elif args.command == "import":
        result = asyncio.run(run_import_graph(args.config, args.input,
                                              args.new_uuid))
        print(f"Graph import completed with UUID: {result}")
    elif args.command == "benchmark":
        result = asyncio.run(run_benchmark(args.config, args.input,
                                           args.output))
        print(f"Benchmark evaluation completed: {result}")
    else:
        parser.print_help()
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
