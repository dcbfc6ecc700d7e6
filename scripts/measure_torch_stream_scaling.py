"""Live multi-stream scaling of the PyTorch port on one CUDA card.

    python3 scripts/measure_torch_stream_scaling.py [--streams 1 2 4 8]
        [--seconds 12] [--seed 0]

The counterpart of ``scripts/measure_stream_scaling.py`` with the port's
on-device captioner: ``backend.vlm: tpu`` as ``make_vlm_client`` serves it
(ViT-B/32 + ``CaptionerConfig.base()`` from seed 0, device preprocessing,
256 new bytes), the hash embed client on the card, and the stream spec of
that script: 240 x 320 frames at 30 fps, 1 s chunks of 5 frames.  Frames
are made with numpy (a moving square of a colour a stream on a dark noisy
background), since the card's machine has no cv2 to decode video.  Each
stream gets a query every ``QUERY_EVERY`` video-seconds while it runs.
``--seconds`` defaults to that script's 12 s of video: at a throughput
factor under 1 a paced run falls behind by a fraction of a second per
video-second, and only a window that long lets the lag pass the engine's
shed limit (two windows a stream) so that shedding can show.

For each stream count it runs ``simulate`` twice, as fast as the card
allows (``realtime=False``: the throughput factor, video-seconds over
wall-seconds) and paced by the wall clock (``realtime=True``: overload
shows as shed chunks and dropped ring frames with the realtime factor near
1), after a short warm-up, and prints one JSON line:

  {"streams", "throughput_factor", "realtime_factor", "chunks_done",
   "shed_chunks", "dropped_frames", "coverage", "chunk_latency_p50_ms",
   "query_p50_under_load_ms", "query_p95_under_load_ms",
   "query_service_p50_ms", "query_service_p95_ms", "batches",
   "chunks_per_batch", ...}

A query's latency under load is what its asker waits: from its arrival
(the wall time of the paced run that matches the query's video time) to
the moment its answer is ready, so it counts the caption batch it waits
behind.  The service time is the engine's own ``query_latencies_ms``,
which starts only when the engine takes the query up.  ``coverage`` is the realtime run's chunks done over the windows the camera
produced (done + shed + whole windows dropped at the rings), as the JAX
script counts it.  A last line profiles one ``process_ready`` of a batch of
``max(--streams)`` chunks: kernel launches and the device's busy share of
its unprofiled wall (``torch.profiler`` stretches the profiled call).
The first line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FPS, CHUNK_SECONDS, FRAMES_PER_CHUNK, HEIGHT, WIDTH = 30.0, 1.0, 5, 240, 320
QUERY_EVERY = 0.5
_COLOURS = [(200, 30, 30), (30, 200, 30), (30, 30, 200), (200, 200, 30),
            (200, 30, 200), (30, 200, 200), (230, 230, 230), (120, 60, 20)]
_QUERY_WORDS = ["red", "green", "blue", "yellow", "magenta", "cyan",
                "white", "brown"]


def frame_bank(stream: int, seed: int, n: int = 60) -> np.ndarray:
    """``n`` uint8 RGB frames [n, 240, 320, 3] of one stream: a square of
    the stream's colour moving along a sine over seeded dark noise."""
    rng = np.random.default_rng(seed + stream)
    frames = rng.integers(0, 40, (n, HEIGHT, WIDTH, 3), dtype=np.uint8)
    side = HEIGHT // 2
    for i in range(n):
        x = int((WIDTH - side) * (0.5 + 0.4 * np.sin(i / 5.0)))
        y = (HEIGHT - side) // 2
        frames[i, y:y + side, x:x + side] = _COLOURS[stream % len(_COLOURS)]
    return frames


def source(bank: np.ndarray):
    """An endless frame iterator over ``bank``."""
    i = 0
    while True:
        yield bank[i % len(bank)]
        i += 1


def specs(n: int):
    from vidgraph_tpu_torch.streams import StreamSpec

    return [StreamSpec(f"cam{i}", fps=FPS, chunk_size_seconds=CHUNK_SECONDS,
                       frames_per_chunk=FRAMES_PER_CHUNK, height=HEIGHT,
                       width=WIDTH) for i in range(n)]


def queries(n: int, seconds: float):
    """(video-time, stream, text): each stream asked every
    ``QUERY_EVERY`` seconds from the first completed chunk on."""
    out = []
    t = CHUNK_SECONDS + 0.1
    while t < seconds:
        for i in range(n):
            word = _QUERY_WORDS[i % len(_QUERY_WORDS)]
            out.append((t, f"cam{i}", f"a {word} object moving in view"))
        t += QUERY_EVERY
    return out


def make_engine(n: int, vlm, embed, kg_extractor=None, engine_cls=None,
                **engine_kw):
    """The engine over ``n`` streams (a ``RealtimeEngine``, or
    ``engine_cls`` with ``engine_kw``), its ``_caption_chunks`` wrapped to
    record each batch's size (``batch_sizes``), its ``query`` to keep each
    answer (``answers``) and the host clock when it was ready
    (``answered_at``, by the answer's ``id``), and its ``submit_query`` to
    keep each submitted query's future in order (``submitted``)."""
    from vidgraph_tpu_torch.streams import RealtimeEngine

    engine = (engine_cls or RealtimeEngine)(
        specs(n), embed_client=embed, vlm_client=vlm,
        kg_extractor=kg_extractor, **engine_kw)
    engine.batch_sizes, engine.answers, engine.submitted = [], [], []
    engine.answered_at = {}
    caption, query = engine._caption_chunks, engine.query
    submit = engine.submit_query

    async def counted(ready):
        engine.batch_sizes.append(len(ready))
        return await caption(ready)

    async def kept(stream_id, text, **kw):
        answer = await query(stream_id, text, **kw)
        engine.answered_at[id(answer)] = time.perf_counter()
        engine.answers.append(answer)
        return answer

    def submitted(stream_id, text):
        fut = submit(stream_id, text)
        engine.submitted.append((time.perf_counter(), fut))
        return fut
    engine._caption_chunks, engine.query = counted, kept
    engine.submit_query = submitted
    return engine


def waits_ms(engine, asked, t0: float, realtime: bool) -> List[float]:
    """Each submitted query's wait from its arrival to its answer (ms).
    ``asked`` is submitted in sorted order; a paced run's query arrives
    at ``t0`` plus its video time, an unpaced one when submitted."""
    asked = sorted(asked)
    assert len(engine.submitted) == len(asked), \
        (len(engine.submitted), len(asked))
    out = []
    for (video_t, _sid, _text), (sent, fut) in zip(asked,
                                                   engine.submitted):
        arrived = t0 + video_t if realtime else sent
        out.append((engine.answered_at[id(fut.result())] - arrived) * 1e3)
    return out


def p50_p95(xs: List[float]):
    xs = sorted(xs)
    return ((statistics.median(xs), xs[int(0.95 * (len(xs) - 1))])
            if xs else (None, None))


def run(n: int, vlm, embed, seconds: float, realtime: bool, seed: int = 0,
        with_queries: bool = True, kg_extractor=None,
        banks: Optional[List[np.ndarray]] = None, **engine_kw):
    """One ``simulate`` over ``n`` streams; returns (engine, summary) with
    the summary's coverage, batch counts and the queries' waits from
    arrival to answer (``query_waits_ms`` in submission order, and their
    ``query_under_load_p50_ms``/``_p95_ms``) added.

    Unpaced, ``simulate`` submits each query when its video time passes.
    Paced, a query arrives at the wall time of its video time, and each
    ``process_ready`` first submits every query that has arrived, so the
    engine takes it up at its next iteration as a live one would.
    ``simulate`` itself would jump over the queries of the video it skips
    when behind the wall clock; its last ``process_ready`` comes after the
    wall clock has passed the video's end, so every query is answered in
    the run.  ``engine_kw`` go to ``make_engine``."""
    from vidgraph_tpu_torch.streams import simulate

    banks = banks or [frame_bank(i, seed) for i in range(n)]
    engine = make_engine(n, vlm, embed, kg_extractor, **engine_kw)
    asked = queries(n, seconds) if with_queries else []
    pending = sorted(asked) if realtime else []
    t0 = time.perf_counter()

    if realtime:
        process_ready = engine.process_ready

        async def arrived_first():
            now = time.perf_counter()
            while pending and t0 + pending[0][0] <= now:
                _t, sid, text = pending.pop(0)
                engine.submit_query(sid, text)
            return await process_ready()
        engine.process_ready = arrived_first

    async def timed():
        nonlocal t0
        t0 = time.perf_counter()
        return await simulate(
            engine, {f"cam{i}": source(banks[i]) for i in range(n)},
            video_seconds=seconds,
            queries=None if realtime else (asked or None),
            realtime=realtime)
    out = asyncio.run(timed())
    waits = waits_ms(engine, asked, t0, realtime)
    wait_p50, wait_p95 = p50_p95(waits)
    done = sum(s["chunks_done"] for s in out["streams"].values())
    window = int(FPS * CHUNK_SECONDS)
    ring_windows = out["total_dropped_frames"] // window
    produced = done + out["total_shed_chunks"] + ring_windows
    lat = [x for st in engine.stats.values() for x in st.chunk_latencies_ms]
    out.update({
        "chunks_done": done,
        "coverage": done / produced if produced else None,
        "chunk_latency_p50_ms": statistics.median(lat) if lat else None,
        "query_waits_ms": waits,
        "query_under_load_p50_ms": wait_p50,
        "query_under_load_p95_ms": wait_p95,
        "batches": len(engine.batch_sizes),
        "chunks_per_batch": (statistics.mean(engine.batch_sizes)
                             if engine.batch_sizes else None)})
    return engine, out


def one_window(engine, banks: List[np.ndarray]) -> None:
    """Push one chunk window of frames into every stream of ``engine``."""
    for i, sid in enumerate(engine.specs):
        for j in range(int(FPS * CHUNK_SECONDS)):
            engine.push_frame(sid, banks[i][j % len(banks[i])])


def profile_process_ready(n: int, vlm, embed, seed: int = 0) -> Dict:
    """One ``process_ready`` of a batch of ``n`` chunks under
    ``torch.profiler``: kernel launches, device busy time, and its share
    of the same call's unprofiled wall (median of 3 after a first)."""
    import torch

    from vidgraph_tpu_torch.core.profiling import profile_device

    banks = [frame_bank(i, seed) for i in range(n)]
    engine = make_engine(n, vlm, embed)

    def process():
        one_window(engine, banks)
        assert asyncio.run(engine.process_ready()) == n

    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        process()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    wall = statistics.median(walls[1:])
    prof = profile_device(process)
    return {"chunks": n, "unprofiled_wall_ms": wall, **prof,
            "device_busy_share": prof["device_busy_ms"] / wall}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def serving_clients():
    """``backend.vlm: tpu`` and ``backend.embedder: tpu`` as the CLI's
    ``stream`` builds them from the default config."""
    from vidgraph_tpu_torch.core.config import PipelineConfig
    from vidgraph_tpu_torch.services.embed_client import make_embed_client
    from vidgraph_tpu_torch.services.vlm_client import make_vlm_client

    config = PipelineConfig()
    embed = make_embed_client("tpu", dim=config.embedding_memory.dim)
    return make_vlm_client("tpu", config.vlm), embed


def scaling_row(n: int, vlm, embed, seconds: float, seed: int) -> Dict:
    run(n, vlm, embed, 2.0, realtime=False, seed=seed, with_queries=False)
    _, thr = run(n, vlm, embed, seconds, realtime=False, seed=seed)
    _, rt = run(n, vlm, embed, seconds, realtime=True, seed=seed)
    return {"streams": n, "video_seconds": seconds,
            "throughput_factor": thr["realtime_factor"],
            "throughput_chunk_latency_p50_ms": thr["chunk_latency_p50_ms"],
            "throughput_chunks_per_batch": thr["chunks_per_batch"],
            "realtime_factor": rt["realtime_factor"],
            "chunks_done": rt["chunks_done"],
            "shed_chunks": rt["total_shed_chunks"],
            "dropped_frames": rt["total_dropped_frames"],
            "coverage": rt["coverage"],
            "chunk_latency_p50_ms": rt["chunk_latency_p50_ms"],
            "query_p50_under_load_ms": rt["query_under_load_p50_ms"],
            "query_p95_under_load_ms": rt["query_under_load_p95_ms"],
            "query_service_p50_ms": rt["query_p50_ms"],
            "query_service_p95_ms": rt["query_p95_ms"],
            "queries_served": rt["queries_served"],
            "batches": rt["batches"],
            "chunks_per_batch": rt["chunks_per_batch"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("measure_torch_stream_scaling: needs a CUDA card",
              file=sys.stderr)
        return 1
    sys.modules["tiktoken"] = None
    print(json.dumps({"card": card(), "torch": torch.__version__}),
          flush=True)
    vlm, embed = serving_clients()
    for n in args.streams:
        print(json.dumps(scaling_row(n, vlm, embed, args.seconds,
                                     args.seed)), flush=True)
    print(json.dumps({"profile_process_ready": profile_process_ready(
        max(args.streams), vlm, embed, args.seed)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
