"""vidgraph_tpu_torch — the video-memory framework in PyTorch and CUDA.

A port of ``vidgraph_tpu`` (the JAX reference, which stays beside it) to
PyTorch on an NVIDIA H100.  The sub-packages and module names mirror the
reference's; host modules that need no accelerator are verbatim copies
(``tests/test_torch_host_copies.py`` keeps them byte-identical).

Ported so far: the query-serving path of the video memory — ``kg`` from a
``vlm_output.json``, the embedding memory with its hand-written CUDA cosine
top-k kernel (``csrc/topk_cosine.cu``), hybrid retrieval, ``benchmark``,
``export`` and ``import``.  ROADMAP.md lists what comes next.

The card is chosen by ``VIDGRAPH_TORCH_DEVICE`` (``core/platform.py``,
default ``cuda``).  Float32 products run in full float32 on the card
(``torch.backends.cuda.matmul.allow_tf32`` is False): the embedder's
projection and the kernel's plain version are held to the JAX package at
1e-6 and 1e-5, which TF32's ten-bit mantissa cannot meet.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"

from .core.config import PipelineConfig  # noqa: E402
from .core.logger import get_logger  # noqa: E402
from .core.metrics import MetricsTracker  # noqa: E402
from .core.platform import PlatformUtils  # noqa: E402

__all__ = ["PipelineConfig", "get_logger", "MetricsTracker", "PlatformUtils"]
