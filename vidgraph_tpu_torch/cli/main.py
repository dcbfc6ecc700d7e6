"""CLI of the PyTorch port, run as ``python -m vidgraph_tpu_torch.cli.main``.

Its code is ``vidgraph_tpu/cli/main.py``'s, all twelve commands: ``vlm``
and its alias ``graph``, ``kg`` (with ``--resume-uuid``), ``retrieve``,
``ask``, ``batch-retrieve``, ``export``, ``import``, ``benchmark``,
``prune``, ``stream`` (the live multi-stream runtime, ``streams/``) and
``serve`` (the HTTP video-memory service, ``services/server.py``), with the
same flags and JSON outputs.

CLI — surface parity with the reference (reference:
src/cli/main.py:187-289): subcommands ``vlm`` (plus ``graph`` alias — the
reference README documented ``graph`` while the parser registered ``vlm``),
``kg``, ``retrieve``, ``batch-retrieve``, ``export``, ``import``,
``benchmark``; identical flags; ``batch-retrieve`` also writes
``metrics/retrieval_times_{uuid}_{timestamp}.json`` with per-query and
average times.

``main`` is the port's own in one respect: under ``torchrun`` every rank
runs the command and only rank 0 writes its files (``cli/ranks.py``);
``stream`` and ``serve`` at a world of more than one rank are led by rank
0, which broadcasts each engine step and request to the followers
(``parallel/leader.py``).
"""
from __future__ import annotations

import argparse
import asyncio
import datetime as _dt
import json
import time
from pathlib import Path
from typing import List, Optional

from ..core.config import PipelineConfig
from ..core.logger import get_logger

logger = get_logger("cli")


# ----------------------------------------------------------------- runners
async def run_vlm_extraction(config_path: str, video: str, output: str):
    from ..pipeline.vlm_extractor import VLMExtractor

    config = PipelineConfig.from_yaml(config_path)
    extractor = VLMExtractor(config)
    result = await extractor.process_video(video, output)
    return output if result else None


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


async def run_streams(args):
    from ..io.video import probe_video
    from ..pipeline.retriever_hybrid import HybridRetriever  # noqa: F401
    from ..services.embed_client import make_embed_client
    from ..services.llm_client import make_chat_client
    from ..services.vlm_client import make_vlm_client
    from ..streams import (LiveKGIngestor, RealtimeEngine, StreamSpec,
                           simulate, video_frame_source)

    config = PipelineConfig.from_yaml(args.config)
    embed = make_embed_client(config.backend.embedder,
                              dim=config.embedding_memory.dim,
                              endpoint=config.embedder.endpoint,
                              model=config.embedder.model,
                              api_key=config.embedder.api_key,
            checkpoint_path=config.embedder.checkpoint_path)
    vlm = make_vlm_client(config.backend.vlm, config.vlm)
    ingestor = None
    if args.live_kg:
        chat = make_chat_client(config.backend.llm,
                                endpoint=config.llm_injector.endpoint,
                                model=config.llm_injector.model_name,
                                api_key=config.llm_injector.api_key,
            checkpoint_path=config.llm_injector.checkpoint_path)
        ingestor = LiveKGIngestor(config, chat, embed)

    specs, sources, durations = [], {}, []
    for i, path in enumerate(args.videos):
        sid = f"stream{i}"
        durations.append(probe_video(path).duration_seconds)
        specs.append(StreamSpec(
            sid, fps=args.fps,
            chunk_size_seconds=config.video.chunk_size_seconds,
            frames_per_chunk=config.video.frames_per_chunk))
        sources[sid] = video_frame_source(path)
    seconds = args.seconds if args.seconds > 0 else min(durations)
    engine = RealtimeEngine(specs, embed_client=embed, vlm_client=vlm,
                            kg_extractor=ingestor)
    queries = []
    for q in args.query:
        t, idx, text = q.split(":", 2)
        queries.append((float(t), f"stream{int(idx)}", text))
    out = await simulate(engine, sources, video_seconds=seconds,
                         queries=queries, realtime=args.realtime)
    if ingestor is not None:
        await ingestor.flush()
        out["graphs"] = {sid: {"nodes": s.get_node_count(),
                               "rels": s.get_relationship_count()}
                         for sid, s in ingestor.stores.items()}
        ingestor.close()
    return out


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
    from ..parallel.mesh import world_size
    from .ranks import rank_scope

    parser = build_parser()
    args = parser.parse_args(argv)
    with rank_scope(args):
        if args.command in ("vlm", "graph"):
            result = asyncio.run(run_vlm_extraction(args.config, args.video,
                                                    args.output))
            print(f"VLM extraction completed: {result}")
        elif args.command == "kg":
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
        elif args.command == "prune":
            from ..pipeline.prune import prune_export_file

            result = prune_export_file(args.input, args.output, args.threshold)
            print(f"Graph pruning completed: {result}")
        elif args.command == "stream":
            from ..parallel import leader

            result = asyncio.run(leader.run_ranked_streams(args)
                                 if world_size() > 1 else run_streams(args))
            if result is not None:
                print(f"Stream run completed: {json.dumps(result)}")
        elif args.command == "serve":
            from ..parallel import leader
            from ..services.server import VideoMemoryServer

            config = PipelineConfig.from_yaml(args.config)
            if getattr(args, "persist_dir", None):
                config.graph_store.persist_dir = args.persist_dir
            print(f"Serving video-memory API on {args.host}:{args.port}")
            if world_size() > 1:
                asyncio.run(leader.serve_ranked(config, args.host,
                                                args.port))
            else:
                server = VideoMemoryServer(config, host=args.host,
                                           port=args.port)
                asyncio.run(server.serve_forever())
        else:
            parser.print_help()
            return 1
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
