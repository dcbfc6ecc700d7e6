"""Writes ``tests/torch_jax_draws.json``: the JAX package's seeded draws,
for checks of the PyTorch port where JAX is absent (``chip_smoke.py``'s
phases 16 and 24 on the card).

    JAX_PLATFORMS=cpu python tests/make_torch_jax_draws.py

Runs the JAX package on the CPU.  The file holds:

* ``draws``: ``jax.random`` bits, a Bernoulli(0.5) mask, normals and
  normals truncated to (-2, 2), from fixed keys;
* ``louvain``: bench.py's 926-node Barabasi-Albert graph as an edge list,
  and ``vidgraph_tpu/pipeline/acs.py::_louvain``'s labels, community count
  and modularity on it, padded as the device sweep pads it;
* ``trees``: ``init_vision_tower(ViTConfig.b32(), 0)`` and
  ``init_params(CaptionerConfig.base(), 0)`` leaf by leaf: shape, float64
  sum and sum of squares, the first 16 values and the SHA-1 of the float32
  bytes;
* ``captions``: ``TPUVLMClient(seed=0)`` at the shipped config (those two
  trees, 256 new bytes, ``preprocess: auto``, which resizes with cv2 where
  it imports, as on the card's machine) on
  ``chip_smoke.py::synthetic_chunks``' frames, one chunk a call as
  ``VLMExtractor`` asks: each chunk's tokens and text.

``draws``, ``louvain`` and ``trees`` are recomputed by
``tests/test_torch_seeded_parity.py``, which fails if the file drifts.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "torch_jax_draws.json"
DRAW_SEED, DRAW_N = 42, 4096
NORMAL_N = 8192
LOUVAIN_NODES, LOUVAIN_M, LOUVAIN_SEED = 926, 2, 0
TREE_SEED, HEAD = 0, 16
CAPTION_CHUNKS, CAPTION_NEW = 3, 256


def f32_b64(a) -> str:
    return base64.b64encode(np.asarray(a, np.float32).tobytes()).decode()


def draws() -> dict:
    key = jax.random.PRNGKey(DRAW_SEED)
    bern = np.asarray(jax.random.bernoulli(key, 0.5, (DRAW_N,)))
    return {
        "seed": DRAW_SEED,
        "bits": [int(v) for v in np.asarray(jax.random.bits(key,
                                                            (DRAW_N,)))],
        "bernoulli_packed": np.packbits(bern).tobytes().hex(),
        "bernoulli_n": DRAW_N,
        "normal_seed": 0,
        "normal_f32": f32_b64(jax.random.normal(jax.random.PRNGKey(0),
                                                (NORMAL_N,))),
        "truncated_seed": 1, "truncated_bounds": [-2.0, 2.0],
        "truncated_f32": f32_b64(jax.random.truncated_normal(
            jax.random.PRNGKey(1), -2.0, 2.0, (NORMAL_N,)))}


def louvain() -> dict:
    import jax.numpy as jnp
    import networkx as nx

    from vidgraph_tpu.pipeline import acs

    graph = nx.barabasi_albert_graph(LOUVAIN_NODES, LOUVAIN_M,
                                     seed=LOUVAIN_SEED)
    adj = nx.to_numpy_array(graph, nodelist=range(LOUVAIN_NODES))
    pad = acs._pad_dim(LOUVAIN_NODES)
    a = np.zeros((pad, pad), np.float32)
    a[:LOUVAIN_NODES, :LOUVAIN_NODES] = adj
    valid = np.zeros(pad, np.float32)
    valid[:LOUVAIN_NODES] = 1.0
    labels, q, k = acs._louvain(jnp.asarray(a), jnp.asarray(valid),
                                jax.random.PRNGKey(42))
    return {"graph": f"networkx.barabasi_albert_graph({LOUVAIN_NODES}, "
                     f"{LOUVAIN_M}, seed={LOUVAIN_SEED})",
            "nodes": LOUVAIN_NODES, "pad": pad,
            "edges": [[int(u), int(v)] for u, v in graph.edges()],
            "labels": [int(v) for v in np.asarray(labels)],
            "communities": int(k), "modularity": float(q)}


def leaf_record(leaf) -> dict:
    a = np.asarray(leaf, np.float32)
    flat = a.reshape(-1).astype(np.float64)
    return {"shape": list(a.shape), "sum": float(flat.sum()),
            "sumsq": float((flat * flat).sum()),
            "head": [float(v) for v in a.reshape(-1)[:HEAD]],
            "sha1": hashlib.sha1(a.tobytes()).hexdigest()}


def flat_leaves(tree, prefix: str) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = {}
    for path, leaf in flat:
        names = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join([prefix] + names)] = leaf
    return out


def trees() -> dict:
    from vidgraph_tpu.models.captioner import CaptionerConfig, init_params
    from vidgraph_tpu.models.vit import ViTConfig, init_vision_tower

    _, vit = init_vision_tower(ViTConfig.b32(), TREE_SEED)
    cap = init_params(CaptionerConfig.base(), TREE_SEED)
    leaves = {**flat_leaves(vit["params"], "vit"),
              **flat_leaves(cap, "cap")}
    return {"seed": TREE_SEED, "vit": "ViTConfig.b32()",
            "cap": "CaptionerConfig.base()",
            "leaves": {k: leaf_record(v) for k, v in sorted(leaves.items())}}


def captions() -> dict:
    from vidgraph_tpu.models import captioner, tokenizer
    from vidgraph_tpu.services.vlm_client import TPUVLMClient

    sys.path.insert(0, str(ROOT))
    from chip_smoke import VISION_FRAMES, VISION_HW, synthetic_chunks

    client = TPUVLMClient(seed=0, max_new=CAPTION_NEW)
    real = captioner.generate
    seen = []

    def recording(*args, **kw):
        out = real(*args, **kw)
        seen.append(np.asarray(out))
        return out

    captioner.generate = recording
    rows = []
    try:
        for _, _, frames in synthetic_chunks(CAPTION_CHUNKS, VISION_FRAMES,
                                             5.0):
            text = client.caption_batch_sync([frames])[0]
            toks = seen.pop()[0]
            assert tokenizer.decode(toks) == text
            rows.append({"tokens": [int(t) for t in toks], "text": text})
    finally:
        captioner.generate = real
    return {"seed": 0, "vit": "ViTConfig.b32()",
            "cap": "CaptionerConfig.base()", "max_new": CAPTION_NEW,
            "preprocess": client.preprocess,
            "fast_resize": client.fast_resize,
            "chunks": CAPTION_CHUNKS, "frames_per_chunk": VISION_FRAMES,
            "frame_hw": list(VISION_HW), "rows": rows}


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    record = {"jax_version": jax.__version__,
              "threefry_partitionable": bool(
                  jax.config.jax_threefry_partitionable),
              "draws": draws(), "louvain": louvain(), "trees": trees(),
              "captions": captions()}
    OUT.write_text(json.dumps(record, sort_keys=True) + "\n")
    print(f"wrote {OUT} ({OUT.stat().st_size / 1e3:.1f} kB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
