"""Stream and serve across ranks: a rank-0 leader and follower ranks.

    torchrun --nproc-per-node N -m vidgraph_tpu_torch.cli.main stream ...
    torchrun --nproc-per-node N -m vidgraph_tpu_torch.cli.main serve ...

The port is SPMD (``parallel/mesh.py``): every rank must issue the same
collectives in the same order, those of the row-sharded memories' search
(``parallel/sharded_search.py``) and those of the tensor-parallel
captioner and chat LM (all-reduces, the decode's all-done check).
``stream`` and ``serve`` are driven by what happens on one process only:
camera frames, the wall clock and the lag shedder, queries, HTTP
requests.  So rank 0 leads:

* it takes the frames, queries and requests, decides each engine step
  (which chunks, which queries) or takes each request, and broadcasts it
  on the control channel before it runs it;
* every follower receives the same step or request and runs it on the
  same inputs in the same order, so that the collectives pair up;
* rank 0 alone answers, prints and writes.

``ControlChannel`` is that channel: a gloo group of its own over every
rank, so that a waiting follower waits on the host and holds no NCCL
collective open.  A message is a small JSON header (stream ids, chunk
indices and labels, query texts, a request's route and body) and the
step's frames as one uint8 tensor, after three integers: its kind
(``STEP``, ``REQUEST``, ``HEARTBEAT``, ``STOP``) and the two lengths.
After each step or request every rank gives its outcome (``ok``, or the
type of the exception it raised) to an all-gather, ``agree``: equal
outcomes go on (an exception every rank raised is raised on every rank,
or answered alike by the server), unequal ones raise ``RankDivergence``
on every rank.  A rank whose step raised waits only ``DIVERGENCE_WAIT_S``
there: if the others do not come, they wait in a collective it skipped,
and it ends its process, which fails theirs (gloo reports the closed
connection).  The leader sends ``HEARTBEAT`` once it has been idle for
``HEARTBEAT_FRACTION`` of the group's timeout, so that an idle follower
never times out, and ``STOP`` at the end of a session, whether it ended
normally, was cancelled or raised.

``RankedEngine`` (a ``RealtimeEngine``) and ``RankedServer`` (a
``VideoMemoryServer``) give the copied classes a leader's and a
follower's side; ``follow_stream`` and ``follow_server`` are the
followers' loops; ``run_ranked_streams`` and ``serve_ranked`` are the
CLI's ``stream`` and ``serve`` at a world of more than one rank.  The
same code runs at a world of one, where nothing is broadcast.
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import os
import sys
import time
import traceback
import zlib
from datetime import timedelta
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.logger import get_logger
from ..services.server import VideoMemoryServer
from ..streams.realtime import RealtimeEngine
from . import mesh as pm

logger = get_logger("leader")

STEP, REQUEST, HEARTBEAT, STOP = range(4)
KINDS = ("step", "request", "heartbeat", "stop")
#: the leader sends a heartbeat once idle for this share of the timeout
HEARTBEAT_FRACTION = 0.25
#: seconds a rank whose step raised waits for the others' outcomes
DIVERGENCE_WAIT_S = 10.0


class RankDivergence(RuntimeError):
    """The ranks did not end a step alike, or the control channel to
    another rank failed: the world cannot go on."""


def _end_process(why: str, error: BaseException) -> None:
    """End this process at once: the other ranks wait in a collective it
    skipped, and only its exit frees them."""
    traceback.print_exception(error)
    sys.stderr.write(f"vidgraph leader: {why}; ending this process\n")
    sys.stderr.flush()
    sys.stdout.flush()
    os._exit(1)


class ControlChannel:
    """Rank 0's messages to the follower ranks, on a gloo group of its own
    over every rank of the default group (``init_group`` starts that group
    when none is, and raises where it cannot).  ``timeout_s``, the
    channel's group timeout, defaults to the default group's."""

    def __init__(self, timeout_s: Optional[float] = None) -> None:
        pm.init_group()
        self.timeout_s = float(timeout_s or pm.group_timeout_s())
        self.heartbeat_s = HEARTBEAT_FRACTION * self.timeout_s
        self.divergence_wait_s = min(DIVERGENCE_WAIT_S, self.timeout_s)
        self.group = dist.new_group(backend="gloo",
                                    timeout=timedelta(seconds=self.timeout_s))
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.leader = self.rank == 0
        self.closed = False
        self._last = time.monotonic()
        self.counts = {kind: 0 for kind in KINDS}
        self.bytes = 0
        self.send_ms: List[float] = []      # the leader's, a message
        self.wait_ms: List[float] = []      # a follower's, a message
        self.agree_ms: List[float] = []

    def _collective(self, fn) -> None:
        if self.closed:
            raise RankDivergence(f"rank {self.rank}: the control channel "
                                 "is closed")
        try:
            fn()
        except Exception as e:      # a rank gone, or the group's timeout
            self.closed = True
            raise RankDivergence(f"rank {self.rank}: the control channel "
                                 f"failed: {e}") from e

    def send(self, kind: int, header: Optional[Dict[str, Any]] = None,
             frames: Sequence[np.ndarray] = ()) -> None:
        """Broadcast one message (rank 0 only); ``frames`` are uint8."""
        if not self.leader:
            raise RuntimeError(f"rank {self.rank} sent on the control "
                               "channel: only rank 0 leads")
        t = time.perf_counter()
        head = json.dumps({**(header or {}),
                           "shapes": [list(f.shape) for f in frames]}
                          ).encode()
        n_frames = sum(f.nbytes for f in frames)
        if self.world > 1:
            body = np.empty(len(head) + n_frames, np.uint8)
            body[:len(head)] = np.frombuffer(head, np.uint8)
            at = len(head)
            for f in frames:
                if f.dtype != np.uint8:
                    raise TypeError(f"frames are uint8, got {f.dtype}")
                body[at:at + f.nbytes] = f.reshape(-1)
                at += f.nbytes
            prefix = torch.tensor([kind, len(head), n_frames])
            self._collective(lambda: (
                dist.broadcast(prefix, 0, group=self.group),
                dist.broadcast(torch.from_numpy(body), 0, group=self.group)))
        self.counts[KINDS[kind]] += 1
        self.bytes += len(head) + n_frames
        self.send_ms.append((time.perf_counter() - t) * 1e3)
        self._last = time.monotonic()

    def recv(self) -> Tuple[int, Dict[str, Any], List[np.ndarray]]:
        """The leader's next message on a follower: (kind, header,
        frames)."""
        t = time.perf_counter()
        prefix = torch.zeros(3, dtype=torch.int64)
        self._collective(lambda: dist.broadcast(prefix, 0, group=self.group))
        kind, n_head, n_frames = prefix.tolist()
        body = torch.empty(n_head + n_frames, dtype=torch.uint8)
        self._collective(lambda: dist.broadcast(body, 0, group=self.group))
        raw = body.numpy()
        header = json.loads(raw[:n_head].tobytes())
        frames, at = [], n_head
        for shape in header.pop("shapes"):
            n = int(np.prod(shape))
            frames.append(raw[at:at + n].reshape(shape))
            at += n
        self.counts[KINDS[kind]] += 1
        self.bytes += n_head + n_frames
        self.wait_ms.append((time.perf_counter() - t) * 1e3)
        return kind, header, frames

    def agree(self, outcome: str, error: Optional[BaseException] = None
              ) -> None:
        """Every rank's outcome of the step it just ran (``ok``, or the
        type of ``error``, what the step raised); raises
        ``RankDivergence`` unless all are equal.  A rank with an ``error``
        waits ``divergence_wait_s`` for the others, then ends its
        process."""
        if self.world == 1:
            return
        t = time.perf_counter()
        mine = torch.tensor([zlib.crc32(outcome.encode())])
        every = [torch.zeros_like(mine) for _ in range(self.world)]
        if error is None:
            self._collective(lambda: dist.all_gather(every, mine,
                                                     group=self.group))
        else:
            try:
                dist.all_gather(every, mine, group=self.group,
                                async_op=True).wait(timeout=timedelta(
                                    seconds=self.divergence_wait_s))
            except Exception as e:
                self.closed = True
                _end_process(f"rank {self.rank}: its step ended in "
                             f"{outcome} and the other ranks did not come "
                             f"to compare ({e})", error)
        self.agree_ms.append((time.perf_counter() - t) * 1e3)
        self._last = time.monotonic()
        codes = [int(c) for c in every]
        if len(set(codes)) > 1:
            self.closed = True
            raise RankDivergence(
                f"rank {self.rank}: the ranks ended a step differently "
                f"(here: {outcome}; outcome codes by rank: {codes})")

    def heartbeat_if_idle(self) -> None:
        """The leader's heartbeat, once idle for ``heartbeat_s``."""
        if (self.leader and not self.closed
                and time.monotonic() - self._last >= self.heartbeat_s):
            self.send(HEARTBEAT)

    def stop(self, reason: str = "end") -> None:
        """End the session: the followers' loops return ``reason``
        (rank 0; nothing on a closed channel)."""
        if self.leader and not self.closed:
            self.send(STOP, {"reason": reason})

    def summary(self) -> Dict[str, Any]:
        """Messages by kind, bytes, and ms a message (median, max)."""
        def stats(xs):
            return ({"n": len(xs), "p50": float(np.median(xs)),
                     "max": max(xs)} if xs else None)
        return {"rank": self.rank, "world": self.world,
                "messages": dict(self.counts), "bytes": self.bytes,
                "send_ms": stats(self.send_ms),
                "wait_ms": stats(self.wait_ms),
                "agree_ms": stats(self.agree_ms)}


@contextlib.contextmanager
def session(channel: ControlChannel) -> Iterator[ControlChannel]:
    """The leader's side of a session: ``STOP`` at its end, with the type
    of the exception that ended it, if one did (which then propagates)."""
    reason = "end"
    try:
        yield channel
    except BaseException as e:
        reason = type(e).__name__
        raise
    finally:
        try:
            channel.stop(reason)
        except RankDivergence:
            if reason == "end":
                raise


# ------------------------------------------------------------------ streams
class RankedEngine(RealtimeEngine):
    """``RealtimeEngine`` at any world size.

    On rank 0 ``process_ready`` runs one or two engine steps: the queries
    waiting and the chunks its rings hold (ring and lag shedder as in the
    copy), broadcast and then run, and after them the queries that came
    meanwhile.  A follower runs the same steps in ``follow_stream``; its
    rings stay empty.  At a world of more than one the ``kg_extractor``
    calls of a step run at its end, in chunk order, and are awaited, since
    they reach collectives (the live graph's sharded search, the
    tensor-parallel chat decode) that a background task would issue at
    another point on each rank; at a world of one they stay background
    tasks, as in the copy.  Per stream the KG batches keep their order
    either way."""

    def __init__(self, specs, embed_client, *args,
                 channel: Optional[ControlChannel] = None, **kw) -> None:
        super().__init__(specs, embed_client, *args, **kw)
        self.channel = channel or ControlChannel()
        self._kg_target = self.kg_extractor
        self._inbox: List[Tuple[str, int, str, np.ndarray]] = []
        self._kg_due: List[tuple] = []
        if self.channel.world > 1 and self.kg_extractor is not None:
            self.kg_extractor = self._defer_kg

    def _defer_kg(self, *call) -> "asyncio.Future":
        self._kg_due.append(call)
        done = asyncio.get_running_loop().create_future()
        done.set_result(None)
        return done

    def _collect_ready_chunks(self):
        """The step's chunks, as ``_step`` was given them."""
        ready, self._inbox = self._inbox, []
        return ready

    async def _drain_queries(self) -> None:
        """Queries run in the steps (``process_ready``)."""

    def _take_queries(self) -> list:
        out = []
        while not self._pending_queries.empty():
            out.append(self._pending_queries.get_nowait())
        return out

    async def process_ready(self) -> int:
        if not self.channel.leader:
            raise RuntimeError("a follower's engine runs follow_stream")
        queries = self._take_queries()
        ready = RealtimeEngine._collect_ready_chunks(self)
        if not queries and not ready:
            self.channel.heartbeat_if_idle()
            return 0
        done = await self._lead(queries, ready)
        later = self._take_queries()
        if later:
            await self._lead(later, [])
        return done

    async def flush_kg(self) -> None:
        """The live KG's last partial batches (``LiveKGIngestor.flush``),
        as a step of every rank (rank 0)."""
        await self._lead([], [], flush=True)

    async def _lead(self, queries, ready, flush: bool = False) -> int:
        self.channel.send(STEP, {
            "queries": [[sid, text] for sid, text, _fut in queries],
            "chunks": [[sid, idx, label] for sid, idx, label, _f in ready],
            "flush": flush}, [frames for *_, frames in ready])
        return await self._step(queries, ready, flush)

    async def _step(self, queries, ready, flush: bool = False) -> int:
        """One engine step, alike on every rank: ``queries`` (sid, text,
        future or None), then ``ready``'s chunks through the copy's
        ``process_ready``, its KG calls, the KG's flush; then ``agree``.
        Returns the chunks done."""
        outcomes, error, done = [], None, 0
        try:
            for sid, text, fut in queries:
                try:
                    answer = await self.query(sid, text)
                except Exception as e:
                    outcomes.append(type(e).__name__)
                    if fut is not None:
                        fut.set_exception(e)
                else:
                    outcomes.append("ok")
                    if fut is not None:
                        fut.set_result(answer)
            if ready:
                self._inbox = list(ready)
                done = await RealtimeEngine.process_ready(self)
            due, self._kg_due = self._kg_due, []
            for call in due:
                await self._kg_target(*call)
            if flush and self._kg_target is not None:
                await self._kg_target.flush()
        except BaseException as e:
            error = e
            outcomes.append(type(e).__name__)
        self.channel.agree(";".join(outcomes) or "ok", error)
        if error is not None:
            raise error
        return done


async def follow_stream(engine: RankedEngine) -> str:
    """A follower's stream session: run each step rank 0 broadcasts until
    its ``STOP``, whose reason it returns."""
    channel = engine.channel
    while True:
        kind, header, frames = channel.recv()
        if kind == HEARTBEAT:
            continue
        if kind == STOP:
            return header["reason"]
        if kind != STEP:
            raise RankDivergence(f"rank {channel.rank}: a {KINDS[kind]} "
                                 "message in a stream session")
        chunks = [(sid, idx, label, f) for (sid, idx, label), f
                  in zip(header["chunks"], frames)]
        await engine._step([(sid, text, None)
                            for sid, text in header["queries"]],
                           chunks, header["flush"])


async def run_ranked_streams(args) -> Optional[Dict[str, Any]]:
    """The CLI's ``stream`` at any world size: ``cli/main.py::run_streams``
    (its clients, specs and summary) with a ``RankedEngine``.  Rank 0 opens
    the videos, drives ``simulate`` and returns the summary; a follower
    opens no video, follows, and returns None."""
    from ..core.config import PipelineConfig
    from ..io.video import probe_video
    from ..services.embed_client import make_embed_client
    from ..services.llm_client import make_chat_client
    from ..services.vlm_client import make_vlm_client
    from ..streams import (LiveKGIngestor, StreamSpec, simulate,
                           video_frame_source)

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
                                checkpoint_path=config.llm_injector
                                .checkpoint_path)
        ingestor = LiveKGIngestor(config, chat, embed)
    specs = [StreamSpec(f"stream{i}", fps=args.fps,
                        chunk_size_seconds=config.video.chunk_size_seconds,
                        frames_per_chunk=config.video.frames_per_chunk)
             for i in range(len(args.videos))]
    engine = RankedEngine(specs, embed_client=embed, vlm_client=vlm,
                          kg_extractor=ingestor)
    try:
        if not engine.channel.leader:
            await follow_stream(engine)
            return None
        with session(engine.channel):
            sources, durations = {}, []
            for spec, path in zip(specs, args.videos):
                durations.append(probe_video(path).duration_seconds)
                sources[spec.stream_id] = video_frame_source(path)
            seconds = args.seconds if args.seconds > 0 else min(durations)
            queries = []
            for q in args.query:
                t, idx, text = q.split(":", 2)
                queries.append((float(t), f"stream{int(idx)}", text))
            out = await simulate(engine, sources, video_seconds=seconds,
                                 queries=queries, realtime=args.realtime)
            if ingestor is not None:
                await engine.flush_kg()
                out["graphs"] = {sid: {"nodes": s.get_node_count(),
                                       "rels": s.get_relationship_count()}
                                 for sid, s in ingestor.stores.items()}
        return out
    finally:
        if ingestor is not None:
            ingestor.close()


# ------------------------------------------------------------------- server
class RankedServer(VideoMemoryServer):
    """``VideoMemoryServer`` at any world size.

    On rank 0 the handlers of ``/v1/ingest``, ``/v1/query`` and
    ``/v1/retrieve`` run one at a time under an ``asyncio.Lock``, each
    broadcasting its route and body before it runs, so that the broadcast
    order is the order they run in; an idle leader beats.  A follower
    binds no socket: ``follow_server`` runs the same handler on each
    request and drops its answer.  An exception every rank's handler
    raised is answered by rank 0 as the copy answers it (a missing field
    400, another 500); one that not every rank raised ends the world
    (``failure``; ``serve_forever`` and ``stop`` raise it).  ``/v1/stats``
    reads host-side counts only, no collective, and is answered by rank 0
    alone.  ``/v1/retrieve`` must find the same graphs on every rank: the
    CLI points a follower's ``graph_store.persist_dir`` at rank 0's, which
    the handlers only read."""

    ROUTES = {"ingest": VideoMemoryServer._ingest,
              "query": VideoMemoryServer._query,
              "retrieve": VideoMemoryServer._retrieve}

    def __init__(self, config=None, host: str = "127.0.0.1",
                 port: int = 8077,
                 channel: Optional[ControlChannel] = None) -> None:
        super().__init__(config, host=host, port=port)
        self.channel = channel or ControlChannel()
        self.failure: Optional[BaseException] = None
        self._lock: Optional[asyncio.Lock] = None
        self._failed: Optional[asyncio.Event] = None
        self._beat: Optional[asyncio.Task] = None

    async def _ingest(self, body: Dict) -> Dict:
        return await self._lead("ingest", body)

    async def _query(self, body: Dict) -> Dict:
        return await self._lead("query", body)

    async def _retrieve(self, body: Dict) -> Dict:
        return await self._lead("retrieve", body)

    async def _lead(self, route: str, body: Dict) -> Dict:
        async with self._lock:
            try:
                self.channel.send(REQUEST, {"route": route, "body": body,
                                            "served": self.requests_served})
                return await self._run(route, body)
            except RankDivergence as e:
                self._fail(e)
                raise

    async def _run(self, route: str, body: Dict) -> Dict:
        """The copy's handler of ``route``, then ``agree``."""
        error = None
        try:
            answer = await self.ROUTES[route](self, body)
        except BaseException as e:
            error = e
        self.channel.agree("ok" if error is None else type(error).__name__,
                           error)
        if error is not None:
            raise error
        return answer

    def _fail(self, error: BaseException) -> None:
        if self.failure is None:
            self.failure = error
            logger.error("the ranks diverged; the server stops: %s", error)
            self._failed.set()

    async def _heartbeats(self) -> None:
        while True:
            await asyncio.sleep(self.channel.heartbeat_s / 2)
            async with self._lock:
                try:
                    self.channel.heartbeat_if_idle()
                except RankDivergence as e:
                    self._fail(e)
                    return

    async def start(self) -> None:
        """Bind the socket and beat while idle (rank 0)."""
        if not self.channel.leader:
            raise RuntimeError("a follower binds no socket: it runs "
                               "follow_server")
        self._lock = asyncio.Lock()
        self._failed = asyncio.Event()
        await super().start()
        self._beat = asyncio.ensure_future(self._heartbeats())

    async def stop(self, reason: str = "end") -> None:
        """Close the socket and end the followers' loops; raise the
        ``failure`` that ended the world, if one did."""
        if self._beat is not None:
            self._beat.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._beat
        await super().stop()
        async with self._lock:
            self.channel.stop(reason)
        if self.failure is not None:
            raise self.failure

    async def serve_forever(self) -> None:
        """Serve until cancelled or until the ranks diverge."""
        await self.start()
        reason = "end"
        try:
            await self._failed.wait()
        except BaseException as e:
            reason = type(e).__name__
            raise
        finally:
            await self.stop(reason)


async def follow_server(server: RankedServer) -> str:
    """A follower's server session: run each request rank 0 broadcasts
    until its ``STOP``, whose reason it returns."""
    channel = server.channel
    while True:
        kind, header, _ = channel.recv()
        if kind == HEARTBEAT:
            continue
        if kind == STOP:
            return header["reason"]
        if kind != REQUEST:
            raise RankDivergence(f"rank {channel.rank}: a {KINDS[kind]} "
                                 "message in a server session")
        server.requests_served = header["served"]
        try:
            await server._run(header["route"], header["body"])
        except RankDivergence:
            raise
        except Exception:   # every rank raised it; rank 0 answers with it
            logger.debug("request %s raised on every rank", header["route"],
                         exc_info=True)


async def serve_ranked(config, host: str, port: int) -> None:
    """The CLI's ``serve`` at any world size: rank 0 serves HTTP until
    cancelled, a follower follows."""
    server = RankedServer(config, host=host, port=port)
    if server.channel.leader:
        await server.serve_forever()
    else:
        await follow_server(server)
