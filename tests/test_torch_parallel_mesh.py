"""The port's mesh arithmetic and tensor-parallel placements against the
JAX package's, and the multichip dry-run on 4 gloo ranks.

* ``_factor`` equal to JAX's for n 1-16 x model_axis 0-8;
* ``captioner_shardings`` and ``vit.param_shardings`` equal, leaf for
  leaf, to the JAX ``PartitionSpec``s read as placements, for
  ``CaptionerConfig.tiny()``/``base()`` and ``ViTConfig.tiny()``/``b32()``
  (shapes only: the trees are traced, no weight is drawn);
* ``dryrun_multichip(4)`` completes every check of ``_dryrun_impl``.
"""
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from vidgraph_tpu.models import captioner as jcap
from vidgraph_tpu.models import train as jtrain
from vidgraph_tpu.models import vit as jvit
from vidgraph_tpu.parallel import mesh as jmesh
from vidgraph_tpu_torch.models import train as ttrain
from vidgraph_tpu_torch.models import vit as tvit
from vidgraph_tpu_torch.parallel import mesh as tmesh
from vidgraph_tpu_torch.parallel.dryrun import dryrun_multichip
from vidgraph_tpu_torch.parallel.launch import run_ranks

AXES = ("data", "model")
# the placements read only the mesh's axis names
MESH = types.SimpleNamespace(mesh_dim_names=AXES)


@pytest.mark.parametrize("model_axis", range(9))
def test_factor_equals_jax(model_axis):
    for n in range(1, 17):
        assert tmesh._factor(n, model_axis) == \
            jmesh._factor(n, model_axis), (n, model_axis)


def _as_placements(spec) -> tuple:
    out = [Replicate()] * len(AXES)
    for dim, axis in enumerate(spec):
        if axis is not None:
            out[AXES.index(axis)] = Shard(dim)
    return tuple(out)


def _meta(tree):
    """A traced JAX tree as meta-device tensors of the same shapes."""
    return jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), tree)


def _pairs(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            yield from _pairs(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)) and not hasattr(want, "spec"):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            yield from _pairs(g, w, f"{path}/{i}")
    else:
        yield path, got, want


@pytest.mark.parametrize("preset", ["tiny", "base"])
def test_captioner_shardings_equal_jax(cpu_mesh, preset):
    cfg = getattr(jcap.CaptionerConfig, preset)()
    shapes = jax.eval_shape(lambda: jcap.init_params(cfg, seed=0))
    want = jtrain.captioner_shardings(shapes, cpu_mesh)
    got = ttrain.captioner_shardings(_meta(shapes), MESH)
    pairs = list(_pairs(got, want))
    assert len(pairs) == len(jax.tree_util.tree_leaves(shapes))
    for path, g, w in pairs:
        assert g == _as_placements(w.spec), path
    assert any(Shard(1) in g for _, g, _ in pairs)


@pytest.mark.parametrize("preset", ["tiny", "b32"])
def test_vit_param_shardings_equal_jax(cpu_mesh, preset):
    cfg = getattr(jvit.ViTConfig, preset)()
    dummy = jnp.zeros((1, cfg.image_size, cfg.image_size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jvit.VisionTower(cfg).init(
        jax.random.PRNGKey(0), dummy))
    want = jvit.param_shardings(shapes, cpu_mesh)
    got = tvit.param_shardings(_meta(shapes), MESH)
    pairs = list(_pairs(got, want))
    assert len(pairs) == len(jax.tree_util.tree_leaves(shapes))
    for path, g, w in pairs:
        assert g == _as_placements(w.spec), path
    assert got["params"]["proj"]["kernel"] == (Replicate(), Shard(0))


def test_mesh_helpers_equal_jax(cpu_mesh):
    for name in ("replicated", "model_sharded_cols", "model_sharded_rows"):
        assert getattr(tmesh, name)(MESH) == _as_placements(
            getattr(jmesh, name)(cpu_mesh).spec), name
    for ndim in (1, 2, 4):
        assert tmesh.data_sharded(MESH, ndim) == _as_placements(
            jmesh.data_sharded(cpu_mesh, ndim).spec)


def test_dryrun_multichip_four_ranks():
    lines = dryrun_multichip(4, deadline_s=240.0)
    assert lines[0].startswith("capacity-scaling")
    assert "exact top-k == host argsort" in lines[0]
    summary = lines[1]
    assert summary.startswith("dryrun_multichip(4): mesh=(2x2)")
    for part in ("sp loss=", "ep err=", "pp(2-stage) err=",
                 "sharded-search OK", "tp caption decode == single-device",
                 "batch serve (tp) == single-device"):
        assert part in summary, part


def test_a_failed_rank_and_a_hung_collective_fail_the_run():
    """A rank that raises fails the run with its output, and the rank
    left waiting in the collective fails with it, well before the group's
    timeout (gloo drops the pair; a rank that still hangs is killed at
    the deadline)."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_ranks("torch_parallel_cases:rank_one_fails", 2,
                  pythonpath=[str(Path(__file__).parent)], deadline_s=120.0)
    assert time.monotonic() - t0 < 120.0 + 10.0
    assert "ranks [0, 1] failed" in str(err.value)
    assert "rank one fails on purpose" in str(err.value)
