"""The port's threefry PRNG (``vidgraph_tpu_torch/core/prng.py``) against
``jax.random`` on the CPU, over keys from several seeds and 1-D and 2-D
shapes.

Tolerances: key operations, ``bits``, ``uniform`` and ``bernoulli`` are
bit-equal.  The normals (``normal``, ``truncated_normal``,
``lecun_normal``) are held within 2 ulp with at least 90 % of draws
bit-equal; on this host every draw of these tests was bit-equal (the port
reproduces XLA's CPU ``log``, ``log1p`` and ``ErfInv`` with their
contracted multiply-adds).  ``flax_key`` equals Flax's own derivation for
every parameter path of ``ViTConfig.tiny()``.
"""
import os

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from flax.core.scope import _fold_in_static  # noqa: E402

from vidgraph_tpu.models import vit as jvit  # noqa: E402
from vidgraph_tpu_torch.core import prng  # noqa: E402

SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 32 - 1, -7]
SHAPES = [(1,), (7,), (1000,), (3, 5), (64, 33)]


def _seeds(n, seed=0):
    return [int(s) for s in np.random.default_rng(seed).integers(
        0, 2 ** 32, size=n)]


def jkey(seed):
    return jax.random.PRNGKey(seed)


def ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 distance in units in the last place (ordered int view)."""
    def ordered(x):
        i = x.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def assert_normals_close(got: np.ndarray, want: np.ndarray) -> float:
    assert got.shape == want.shape and got.dtype == np.float32
    assert int(ulps(got, want).max()) <= 2
    share = float(np.mean(got == want))
    assert share >= 0.9, share
    return share


def test_partitionable_threefry_is_jax_default():
    """The port implements only this mode; a JAX that changes it fails
    here first."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_equals_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(jkey(seed)))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("num", [2, 3, 20])
def test_split_equals_jax(seed, num):
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), num),
                                  np.asarray(jax.random.split(jkey(seed),
                                                              num)))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_fold_in_equals_jax(seed):
    for data in [0, 1, 12345] + _seeds(3, seed % 97):
        np.testing.assert_array_equal(
            prng.fold_in(prng.PRNGKey(seed), data),
            np.asarray(jax.random.fold_in(jkey(seed), data)))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_equal_jax(shape):
    for seed in _seeds(3, sum(shape)):
        got = prng.bits(prng.PRNGKey(seed), shape).numpy()
        want = np.asarray(jax.random.bits(jkey(seed), shape))
        np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_bits_across_chunks_equal_jax(monkeypatch):
    """A draw cut into several chunks hashes the same flat indices."""
    monkeypatch.setattr(prng, "HOST_CHUNK", 1000)
    got = prng.bits(prng.PRNGKey(3), (7, 513)).numpy()
    np.testing.assert_array_equal(
        got.astype(np.uint32), np.asarray(jax.random.bits(jkey(3), (7, 513))))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.0, 5.5), (-0.9, 0.2)])
@pytest.mark.parametrize("shape", [(1000,), (40, 25)])
def test_uniform_equals_jax(lo, hi, shape):
    for seed in _seeds(2, int(hi * 10)):
        got = prng.uniform(prng.PRNGKey(seed), shape, lo, hi).numpy()
        want = np.asarray(jax.random.uniform(jkey(seed), shape,
                                             minval=lo, maxval=hi))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.5, 0.1, 0.9])
@pytest.mark.parametrize("shape", [(4096,), (20, 128)])
def test_bernoulli_equals_jax(p, shape):
    for seed in _seeds(2, int(p * 10)) + [42]:
        got = prng.bernoulli(prng.PRNGKey(seed), p, shape).numpy()
        want = np.asarray(jax.random.bernoulli(jkey(seed), p, shape))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(100_000,), (300, 333)])
def test_normal_within_two_ulp_of_jax(shape):
    for seed in [0, 42] + _seeds(1, 5):
        got = prng.normal(prng.PRNGKey(seed), shape).numpy()
        assert_normals_close(got, np.asarray(jax.random.normal(jkey(seed),
                                                               shape)))


@pytest.mark.parametrize("lower,upper", [(-2.0, 2.0), (-1.0, 3.0)])
def test_truncated_normal_within_two_ulp_of_jax(lower, upper):
    for seed in [0, 7]:
        got = prng.truncated_normal(prng.PRNGKey(seed), lower, upper,
                                    (200, 500)).numpy()
        want = np.asarray(jax.random.truncated_normal(
            jkey(seed), lower, upper, (200, 500)))
        assert_normals_close(got, want)
        assert got.min() > lower and got.max() < upper


@pytest.mark.parametrize("shape", [(3072, 768), (64, 192), (7, 5)])
def test_lecun_normal_within_two_ulp_of_jax(shape):
    init = jax.nn.initializers.lecun_normal()
    got = prng.lecun_normal(prng.PRNGKey(11), shape).numpy()
    assert_normals_close(got, np.asarray(init(jkey(11), shape)))


def _flax_param_paths(cfg):
    """(module path, parameter name) of every leaf of the Flax tree."""
    _, params = jvit.init_vision_tower(cfg, 0)
    flat = jax.tree_util.tree_flatten_with_path(params["params"])[0]
    return [tuple(k.key for k in path) for path, _ in flat]


@pytest.mark.parametrize("seed", [0, 3])
def test_flax_key_equals_flax_for_every_vit_leaf(seed):
    counter = {"kernel": 1, "scale": 1, "bias": 2, "cls": 1, "pos": 2}
    paths = _flax_param_paths(jvit.ViTConfig.tiny())
    assert len(paths) == 32
    root = jkey(seed)
    for *scope, leaf in paths:
        want = np.asarray(_fold_in_static(root, (*scope, counter[leaf])))
        got = prng.flax_key(prng.PRNGKey(seed), scope, counter[leaf])
        np.testing.assert_array_equal(got, want, err_msg=str(scope))


def test_draws_are_the_same_on_every_call_and_chunking(monkeypatch):
    key = prng.PRNGKey(5)
    whole = prng.normal(key, (5000,))
    monkeypatch.setattr(prng, "HOST_CHUNK", 777)
    assert np.array_equal(whole.numpy(), prng.normal(key, (5000,)).numpy())


@pytest.mark.parametrize("seed", [2 ** 32, 2 ** 33 + 5, 2 ** 63 - 1,
                                  -2 ** 31 - 1, -2 ** 40])
def test_prng_key_wraps_wide_seeds_as_jax_does(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(jkey(seed)))
