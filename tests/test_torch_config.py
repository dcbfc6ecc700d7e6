"""The port's configuration tree against the JAX package's: every YAML file
under ``config/`` loads to an equal dict in both."""
import os
from pathlib import Path

os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"

import pytest  # noqa: E402

from vidgraph_tpu.core.config import \
    PipelineConfig as JaxConfig  # noqa: E402
from vidgraph_tpu_torch.core.config import PipelineConfig  # noqa: E402

CONFIGS = sorted((Path(__file__).parent.parent / "config").glob("*.yaml"))


def test_every_config_file_is_covered():
    assert len(CONFIGS) >= 6


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_file_loads_equal(path):
    got = PipelineConfig.from_yaml(str(path)).model_dump()
    assert got == JaxConfig.from_yaml(str(path)).model_dump()


def test_defaults_and_unknown_keys_equal():
    raw = {"retrieval": {"top_k_chunks": 7, "not_a_field": 1},
           "chunking": {"max_connection_subgraph": 3}}
    assert PipelineConfig.from_dict(raw).to_dict() == \
        JaxConfig.from_dict(raw).to_dict()
    assert PipelineConfig().model_dump() == JaxConfig().model_dump()


@pytest.fixture
def serving_policy():
    """The serving policy and any process group a test makes, undone."""
    from vidgraph_tpu_torch.parallel import mesh, serving

    yield serving
    serving.configure(enabled="auto", model_axis=1)
    mesh.shutdown()


@pytest.mark.parametrize("mesh", [{"model_axis": 2}, {"data_axis": 4},
                                  {"enabled": True, "model_axis": 8}])
def test_multi_device_mesh_raises(mesh, serving_policy):
    """A ``mesh:`` section wider than one device loads (it raised before
    the port had meshes) and records the serving policy; ``enabled:
    true`` then builds a mesh over this process's world of one (the model
    axis is factored into the world: (1, 1))."""
    import torch.distributed as dist

    cfg = PipelineConfig.from_dict({"mesh": mesh})
    assert cfg.mesh.model_axis == mesh.get("model_axis", 1)
    assert serving_policy._policy == {"enabled": mesh.get("enabled", "auto"),
                                      "model_axis": cfg.mesh.model_axis}
    built = serving_policy.serving_mesh()
    if mesh.get("enabled") is True:
        assert tuple(built.shape) == (1, 1)
        assert built.mesh_dim_names == ("data", "model")
        assert dist.get_world_size() == 1
    else:
        assert built is None            # auto at a world of one


def test_enabled_mesh_of_one_device_builds_a_world_one_mesh(serving_policy):
    """``mesh: {enabled: true, model_axis: 1}`` builds a world-1 mesh on
    the port's device, and the serving stores are row-sharded over it."""
    import torch.distributed as dist

    PipelineConfig.from_dict({"mesh": {"enabled": True, "model_axis": 1}})
    built = serving_policy.serving_mesh()
    assert tuple(built.shape) == (1, 1) and dist.get_world_size() == 1
    assert dist.get_backend() == "gloo"
    store = serving_policy.make_embedding_store(dim=8)
    assert type(store).__name__ == "ShardedEmbeddingStore"


@pytest.mark.parametrize("mesh", [{"enabled": False, "model_axis": 2},
                                  {"enabled": "auto", "model_axis": 1},
                                  {"data_axis": 1}])
def test_single_device_mesh_loads(mesh):
    assert PipelineConfig.from_dict({"mesh": mesh}).mesh.model_axis >= 1
