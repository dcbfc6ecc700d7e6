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


@pytest.mark.parametrize("mesh", [{"model_axis": 2}, {"data_axis": 4},
                                  {"enabled": True, "model_axis": 8}])
def test_multi_device_mesh_raises(mesh):
    with pytest.raises(NotImplementedError, match="one card"):
        PipelineConfig.from_dict({"mesh": mesh})


@pytest.mark.parametrize("mesh", [{"enabled": False, "model_axis": 2},
                                  {"enabled": "auto", "model_axis": 1},
                                  {"data_axis": 1}])
def test_single_device_mesh_loads(mesh):
    assert PipelineConfig.from_dict({"mesh": mesh}).mesh.model_axis >= 1
