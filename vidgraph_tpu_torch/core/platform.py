"""Platform probing for the PyTorch port (counterpart of
``vidgraph_tpu/core/platform.py``, which discovers JAX devices).

``device()`` is the one place the port picks its accelerator: the
``VIDGRAPH_TORCH_DEVICE`` environment variable, ``cuda`` by default.  A
CUDA device that is asked for and absent raises — nothing silently carries
on on the CPU.  The CPU tests set ``VIDGRAPH_TORCH_DEVICE=cpu``.
"""
from __future__ import annotations

import os
import platform
import sys
from pathlib import Path
from typing import Dict, List

import torch

DEVICE_ENV = "VIDGRAPH_TORCH_DEVICE"


def device() -> torch.device:
    """The device the port computes on (``VIDGRAPH_TORCH_DEVICE``)."""
    dev = torch.device(os.environ.get(DEVICE_ENV, "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{DEVICE_ENV}={dev} but torch.cuda.is_available() is false; "
            f"set {DEVICE_ENV}=cpu to run on the host")
    return dev


def describe_device(dev: torch.device) -> Dict[str, object]:
    """Name, count and memory of the card behind ``dev`` (for records)."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": platform.processor() or "cpu",
                "count": 1}
    props = torch.cuda.get_device_properties(dev)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(),
            "sm_count": props.multi_processor_count,
            "capability": f"{props.major}.{props.minor}",
            "memory_gb": round(props.total_memory / 2 ** 30, 1)}


class PlatformUtils:
    @staticmethod
    def get_worker_count() -> int:
        return max(1, (os.cpu_count() or 2) - 1)

    @staticmethod
    def get_video_backend() -> str:
        if sys.platform == "darwin":
            return "avfoundation"
        return "opencv"

    @staticmethod
    def get_accelerator() -> str:
        """'gpu' or 'cpu' for the device the port computes on."""
        return "gpu" if device().type == "cuda" else "cpu"

    @staticmethod
    def get_devices() -> List[torch.device]:
        dev = device()
        if dev.type == "cuda":
            return [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        return [dev]

    @staticmethod
    def device_count() -> int:
        return len(PlatformUtils.get_devices())

    @staticmethod
    def get_data_dir(app: str = "vidgraph") -> Path:
        if sys.platform == "darwin":
            base = Path.home() / "Library" / "Application Support"
        elif platform.system() == "Windows":
            base = Path(os.environ.get("APPDATA", Path.home()))
        else:
            base = Path(os.environ.get("XDG_DATA_HOME",
                                       Path.home() / ".local" / "share"))
        d = base / app
        d.mkdir(parents=True, exist_ok=True)
        return d
