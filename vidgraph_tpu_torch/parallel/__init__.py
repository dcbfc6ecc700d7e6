"""Multi-device plumbing of the port on ``torch.distributed``: meshes,
collectives, the row-sharded embedding search, tensor-parallel serving,
expert and pipeline parallelism (counterparts of
``vidgraph_tpu/parallel/``), and the rank-0 leader that streams and
serves across ranks (``leader.py``, the port's own)."""
from .mesh import (DATA_AXIS, MODEL_AXIS, build_mesh, data_sharded,
                   host_cpu_mesh, model_sharded_cols, model_sharded_rows,
                   replicated, single_device_mesh, use_mesh)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "build_mesh", "data_sharded", "host_cpu_mesh",
    "model_sharded_cols", "model_sharded_rows", "replicated",
    "single_device_mesh", "use_mesh",
]
