"""The port's ``prune``, ``stream`` and ``serve`` commands and its
``utils`` against the JAX package's.

``prune`` writes the same bytes as ``python -m vidgraph_tpu.cli.main
prune`` on an exported graph; ``stream`` on a 240 x 320 synthetic mp4
under ``backend.vlm: local`` prints the JAX CLI's JSON, timings aside;
``serve`` answers over HTTP; the utils give the JAX utils' results.
"""
import asyncio
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from vidgraph_tpu.cli.main import main as jax_main  # noqa: E402
from vidgraph_tpu.io.video import write_synthetic_video  # noqa: E402
from vidgraph_tpu_torch.cli.main import main as torch_main  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TIMING_KEYS = {"chunk_latency_p50_ms", "query_p50_ms", "query_p95_ms",
               "wall_seconds", "aggregate_fps", "realtime_factor"}


def _exported_graph(path: Path) -> Path:
    """An export (format 1.0) of an embedded graph with parallel
    relations between the same pairs, written by the JAX package."""
    from vidgraph_tpu.graph.embedded import EmbeddedGraphStore

    s = EmbeddedGraphStore("prune-src", persist_dir=None, persist=False,
                           dim=64)
    trip = [("Person", "holds", "Beaker"), ("Person", "is_holding", "Beaker"),
            ("Person", "threw_away", "Beaker"), ("Table", "contains", "Flask"),
            ("Beaker", "is_on", "Balance"), ("Beaker", "sits_on", "Balance"),
            ("Beaker", "rests_on", "Balance"), ("Glove", "near", "Bench")]
    s.add_batch_to_graph(
        [{"head": h, "relation": r, "tail": t, "source_chunks": ["p_0_0"]}
         for h, r, t in trip],
        [{"time": "00:00-00:05", "content": "c"}], 0,
        text_chunks=[{"id": "p_0_0", "content": "a person holds a beaker",
                      "index": 0, "embedding": [0.1] * 64}])
    path.write_text(json.dumps(s.export_data()))
    return path


@pytest.mark.parametrize("threshold", ["0.5", "0.8", "0.95"])
def test_prune_output_is_byte_equal(tmp_path, threshold, capsys):
    src = _exported_graph(tmp_path / "export.json")
    outs = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        out = tmp_path / f"pruned_{name}.json"
        assert main(["prune", "--input", str(src), "--output", str(out),
                     "--threshold", threshold]) == 0
        outs[name] = out.read_bytes()
    assert outs["torch"] == outs["jax"]
    rels = json.loads(outs["torch"])["relationships"]
    assert any(r["type"] == "FROM_CHUNK" for r in rels)
    assert "Graph pruning completed" in capsys.readouterr().out


def test_prune_module_main_is_byte_equal(tmp_path):
    from vidgraph_tpu.pipeline.prune import main as jmain
    from vidgraph_tpu_torch.pipeline.prune import main as tmain

    src = _exported_graph(tmp_path / "in.json")
    assert jmain(["--input", str(src), "--output", str(tmp_path / "j")]) == 0
    assert tmain(["--input", str(src), "--output", str(tmp_path / "t")]) == 0
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def _stream_json(main, argv, capsys):
    assert main(argv) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("Stream run completed: ")][-1]
    out = json.loads(line.split(": ", 1)[1])
    for s in out["streams"].values():
        s.pop("chunk_latency_p50_ms")
    return {k: v for k, v in out.items() if k not in TIMING_KEYS}


@pytest.mark.parametrize("live_kg", [False, True])
def test_stream_cli_gives_the_jax_json(tmp_path, capsys, monkeypatch,
                                       live_kg):
    monkeypatch.chdir(tmp_path)
    videos = [write_synthetic_video(str(tmp_path / f"v{i}.mp4"), scenes,
                                    seconds_per_scene=2.0, fps=10)
              for i, scenes in enumerate((["red", "blue"],
                                          ["green", "yellow"]))]
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("backend:\n  vlm: local\n  llm: local\n  embedder: tpu\n"
                   "video:\n  chunk_size_seconds: 1.0\n"
                   "  frames_per_chunk: 3\n"
                   "kg:\n  batch_size: 2\n"
                   f"graph_store:\n  persist_dir: {tmp_path / 'gs'}\n"
                   "acs:\n  backend: networkx\n")
    argv = ["stream", "--config", str(cfg), "--videos", *videos,
            "--fps", "10", "--query", "1.5:0:a red object",
            "--query", "3.0:1:a yellow shape"]
    if live_kg:
        argv.append("--live-kg")
    ref = _stream_json(jax_main, argv, capsys)
    got = _stream_json(torch_main, argv, capsys)
    assert got == ref
    assert got["queries_served"] == 2
    assert all(s["chunks_done"] == 4 for s in got["streams"].values())
    if live_kg:
        assert all(g["nodes"] > 0 for g in got["graphs"].values())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_cli_answers_over_http(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("backend:\n  llm: local\n  embedder: tpu\n")
    port = _free_port()
    env = {**os.environ, "VIDGRAPH_TORCH_DEVICE": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.Popen(
        [sys.executable, "-m", "vidgraph_tpu_torch.cli.main", "serve",
         "--config", str(cfg), "--port", str(port)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    async def ask():
        for _ in range(300):
            try:
                reader, writer = await asyncio.open_connection("127.0.0.1",
                                                               port)
                break
            except OSError:
                await asyncio.sleep(0.1)
        writer.write(b"GET /v1/stats HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Length: 0\r\n\r\n")
        await writer.drain()
        raw = await reader.read()
        writer.close()
        return raw
    try:
        raw = asyncio.run(asyncio.wait_for(ask(), 60))
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    head, _, body = raw.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200")
    assert json.loads(body) == {"ok": True, "requests_served": 1,
                                "streams": {}, "graphs_open": []}
    assert f"Serving video-memory API on 127.0.0.1:{port}" in out


def test_every_command_is_ported():
    import importlib

    tcli = importlib.import_module("vidgraph_tpu_torch.cli.main")
    assert not hasattr(tcli, "NOT_PORTED")
    commands = set(tcli.build_parser()._subparsers._group_actions[0].choices)
    assert len(commands) == 12 and {"stream", "serve", "prune"} <= commands


def test_embedding_utils_equal():
    from vidgraph_tpu.utils import EmbeddingUtils as J
    from vidgraph_tpu_torch.utils import EmbeddingUtils as T

    texts = ["blue glove", "blue gloves", "stock market", ""]
    np.testing.assert_allclose(T(dim=64).create_embeddings(texts),
                               J(dim=64).create_embeddings(texts),
                               atol=1e-6, rtol=0)
    u = T(dim=64)
    v = u.create_embeddings(texts[:3])
    assert u.cosine_similarity(v[0], v[1]) > u.cosine_similarity(v[0], v[2])
    assert u.cosine_similarity([0, 0], [0, 0]) == 0.0


def test_frame_utils_equal(tmp_path):
    from vidgraph_tpu import utils as J
    from vidgraph_tpu_torch import utils as T

    video = write_synthetic_video(str(tmp_path / "v.mp4"), ["red", "blue"],
                                  seconds_per_scene=1.0, fps=5)
    ref, got = J.extract_keyframes(video, 4), T.extract_keyframes(video, 4)
    assert len(got) == len(ref) == 4
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert T.frames_to_base64(got) == J.frames_to_base64(ref)
    big = np.random.default_rng(0).integers(0, 256, (1440, 2560, 3),
                                            dtype=np.uint8)
    assert np.array_equal(T.resize_frame(big), J.resize_frame(big))
    with pytest.raises(FileNotFoundError):
        T.extract_keyframes(str(tmp_path / "absent.mp4"))
