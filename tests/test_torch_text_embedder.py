"""The port's hashed n-gram embedder against the JAX package's.

Same texts, same seed: embeddings within 1e-6 (float32 products summed in
another order), whether the JAX package projects on the host (batches
under ``device_min_batch``) or through its jitted device path.  The
native C++ hasher and the numpy path count the same n-grams.
"""
import os

os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from vidgraph_tpu.models.text_embedder import \
    HashedNGramEmbedder as JaxEmbedder  # noqa: E402
from vidgraph_tpu_torch import native  # noqa: E402
from vidgraph_tpu_torch.convert import projection_from_numpy  # noqa: E402
from vidgraph_tpu_torch.models import text_embedder as te  # noqa: E402
from vidgraph_tpu_torch.services.embed_client import \
    make_embed_client  # noqa: E402

TEXTS = [
    "The person holds a red beaker on the laboratory bench.",
    "A blue flask sits nearby",
    "Time: 00:05 Content: gloves, goggles and a -56.301 g reading",
    "",
    "a",
    "Ünïcödé — 温度计 and a thermometer",
    "The person holds a red beaker on the laboratory bench.",
]


def _random_texts(n, seed):
    rng = np.random.default_rng(seed)
    words = ["red", "blue", "beaker", "flask", "holds", "bench", "scale",
             "the", "person", "a", "on", "weighs", "12.5", "g"]
    return [" ".join(rng.choice(words, size=rng.integers(1, 20)))
            for _ in range(n)]


@pytest.mark.parametrize("device_min_batch", [1, 1024])
def test_embeddings_match_jax(device_min_batch):
    texts = TEXTS + _random_texts(40, seed=device_min_batch)
    want = JaxEmbedder(dim=512, device_min_batch=device_min_batch)\
        .embed(texts)
    got = te.HashedNGramEmbedder(dim=512).embed(texts)
    assert got.dtype == np.float32 and got.shape == (len(texts), 512)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_cached_and_query_embeddings_are_stable():
    emb = te.HashedNGramEmbedder(dim=64, seed=3)
    first = emb.embed(TEXTS)
    np.testing.assert_array_equal(emb.embed(TEXTS), first)
    np.testing.assert_array_equal(emb.embed_query(TEXTS[1]), first[1])
    assert emb.embed([]).shape == (0, 64)
    np.testing.assert_allclose(np.linalg.norm(first[[0, 1, 2]], axis=1), 1.0,
                               atol=1e-6)


def test_native_and_numpy_hashers_count_the_same():
    texts = TEXTS + _random_texts(25, seed=7)
    counts = native.ngram_counts_batch(texts, 4096)
    assert counts is not None, "the native hasher did not build"
    numpy_counts = np.stack([te._ngram_hashes(t, 4096) for t in texts])
    np.testing.assert_array_equal(counts, numpy_counts)


def test_projection_from_numpy_reproduces_the_jax_embedder():
    jax_emb = JaxEmbedder(dim=128, n_buckets=1024, seed=11)
    emb = projection_from_numpy(jax_emb._proj_host)
    assert (emb.dim, emb.n_buckets) == (128, 1024)
    np.testing.assert_allclose(emb.embed(TEXTS), jax_emb.embed(TEXTS),
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        emb.set_projection(np.zeros((3, 3), np.float32))


def test_embed_client_serves_the_hash_embedder():
    client = make_embed_client("tpu", dim=512)
    np.testing.assert_allclose(client.embed(TEXTS[:2]),
                               JaxEmbedder(dim=512).embed(TEXTS[:2]),
                               atol=1e-6, rtol=0)

