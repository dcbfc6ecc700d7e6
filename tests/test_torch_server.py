"""The port's HTTP video-memory server against the JAX package's.

``tests/test_server.py``'s contract cases, each run against both servers
on the same requests: status codes and JSON bodies must be equal, scores
within 1e-5, retrieved texts equal.
"""
import asyncio
import json
import os

os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"

import pytest  # noqa: E402

from vidgraph_tpu.core.config import PipelineConfig as JConfig  # noqa: E402
from vidgraph_tpu.graph.embedded import \
    EmbeddedGraphStore as JStore  # noqa: E402
from vidgraph_tpu.services.server import \
    VideoMemoryServer as JServer  # noqa: E402
from vidgraph_tpu_torch.core.config import \
    PipelineConfig as TConfig  # noqa: E402
from vidgraph_tpu_torch.graph.embedded import \
    EmbeddedGraphStore as TStore  # noqa: E402
from vidgraph_tpu_torch.services.server import \
    VideoMemoryServer as TServer  # noqa: E402

SCORE_TOL = 1e-5
PKGS = {"jax": (JConfig, JServer, JStore), "torch": (TConfig, TServer, TStore)}


async def _http(host, port, method, path, body=None):
    reader, writer = await asyncio.open_connection(host, port)
    payload = json.dumps(body).encode() if body is not None else b""
    req = (f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
           f"Content-Type: application/json\r\n"
           f"Content-Length: {len(payload)}"
           f"\r\nConnection: close\r\n\r\n").encode() + payload
    writer.write(req)
    await writer.drain()
    out = await reader.read()
    writer.close()
    head, _, resp_body = out.partition(b"\r\n\r\n")
    if not head:
        return None, None
    return int(head.split(b" ")[1]), json.loads(resp_body)


INGEST = [
    {"stream": "cam0", "chunk_id": "cam0_0",
     "content": "a red beaker on the lab bench", "time": "00:00-00:04"},
    {"stream": "cam0", "chunk_id": "cam0_1",
     "content": "a blue glove near the balance"},
    {"stream": "cam0", "chunk_id": "cam0_2",
     "content": "the balance reads 42.5 g", "time": "00:08-00:12"},
    {"stream": "cam1", "chunk_id": "cam1_0",
     "content": "a person pours liquid into a flask"},
]
REQUESTS = [
    *[("POST", "/v1/ingest", b) for b in INGEST],
    ("POST", "/v1/query", {"stream": "cam0",
                           "query": "where is the red beaker", "k": 1}),
    ("POST", "/v1/query", {"stream": "cam0", "query": "balance", "k": 3}),
    ("POST", "/v1/query", {"stream": "cam0", "query": "balance", "k": 3,
                           "threshold": 0.2}),
    ("POST", "/v1/query", {"stream": "cam1", "query": "flask"}),
    ("GET", "/v1/stats", None),
    ("POST", "/v1/query", {"stream": "ghost", "query": "x"}),
    ("POST", "/v1/ingest", {"stream": "s"}),
    ("GET", "/nope", None),
    ("GET", "/v1/stats", None),
]


def _serve(pkg, requests, setup=None, tmp_path=None):
    config_cls, server_cls, store_cls = PKGS[pkg]

    async def run():
        cfg = config_cls()
        cfg.backend.llm = "local"
        if tmp_path is not None:
            cfg.graph_store.persist_dir = str(tmp_path / pkg)
            setup(store_cls, str(tmp_path / pkg))
        server = server_cls(cfg, port=0)
        await server.start()
        out = []
        for method, path, body in requests:
            out.append(await _http(server.host, server.port, method, path,
                                   body))
        await server.stop()
        return out
    return asyncio.run(run())


def _assert_same(got, ref):
    """Equal JSON with float scores within ``SCORE_TOL``."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), (got, ref)
        for k in ref:
            _assert_same(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), (got, ref)
        for g, r in zip(got, ref):
            _assert_same(g, r)
    elif isinstance(ref, float):
        assert abs(got - ref) <= SCORE_TOL, (got, ref)
    else:
        assert got == ref, (got, ref)


def test_server_ingest_query_stats_equal():
    ref, got = _serve("jax", REQUESTS), _serve("torch", REQUESTS)
    _assert_same(got, ref)
    codes = [c for c, _ in got]
    assert codes[:4] == [200] * 4 and codes[-4:] == [200, 400, 404, 200]
    assert got[0][1]["memory_size"] == 1
    assert got[4][1]["chunks"][0]["id"] == "cam0_0"
    assert got[8][1]["streams"] == {"cam0": 3, "cam1": 1}
    assert not got[9][1]["ok"]


def _graph(store_cls, persist_dir):
    s = store_cls("srv", persist_dir=persist_dir, dim=512)
    s.add_batch_to_graph(
        [{"head": "Person", "relation": "holds", "tail": "Beaker",
          "source_chunks": ["srv_0_0"]},
         {"head": "Beaker", "relation": "is_on", "tail": "Balance",
          "source_chunks": ["srv_0_1"]}],
        [{"time": "00:00-00:04", "content": "x"}], 0,
        text_chunks=[{"id": "srv_0_0", "content": "person holds a beaker",
                      "index": 0},
                     {"id": "srv_0_1", "content": "the beaker is on a "
                                                  "balance", "index": 1}])
    s.close()


@pytest.mark.parametrize("query", ["who holds the beaker?",
                                   "what is on the balance?"])
def test_server_retrieve_endpoint_equal(tmp_path, query):
    reqs = [("POST", "/v1/retrieve", {"graph_uuid": "srv", "query": query}),
            ("POST", "/v1/retrieve", {"graph_uuid": "srv", "query": query,
                                      "groundtruth": "a person"}),
            ("GET", "/v1/stats", None)]
    ref = _serve("jax", reqs, _graph, tmp_path)
    got = _serve("torch", reqs, _graph, tmp_path)
    for (gc, g), (rc, r) in zip(got, ref):
        assert gc == rc == 200
        assert set(g) == set(r)
        for k in r:
            if k not in ("time", "retrieval_time", "latency_ms"):
                assert g[k] == r[k], k
    assert got[0][1]["retrieval"].startswith("Found results")
    assert got[2][1]["graphs_open"] == ["srv"]
