"""Build and load the hand-written CUDA kernels under ``csrc/``.

At first use, ``nvcc`` compiles the sources into one shared library with a
plain C interface, named by the SHA-256 of the sources
(``build/kernels/libvidgraph_kernels_<sha>.so`` at the repository root),
and ``ctypes`` loads it.  A library
whose sources have not changed is reused.  ``ptxas`` reports each kernel's
registers and shared memory into the ``.log`` beside the library.

Nothing here runs at import: the CPU tests import every module of the port
on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
library_path: Optional[Path] = None
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of vidgraph_tpu_torch are built on first use")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cosine_score_tile_launch.argtypes = [p, p, i, i, i, i, i, p, p, p, p]
    lib.cosine_score_tile_launch.restype = i
    lib.cosine_topk_merge_launch.argtypes = [p, p, i, i, i, p, p, p]
    lib.cosine_topk_merge_launch.restype = i
    lib.cosine_tile_rows.restype = i
    lib.cosine_max_dim.restype = i


def library() -> ctypes.CDLL:
    """The kernels' library, compiled on first call in this checkout."""
    global _lib, library_path
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        digest = hashlib.sha256()
        for src in srcs:
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
        tag = digest.hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"libvidgraph_kernels_{tag}.so"
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=600)
            out.with_suffix(".log").write_text(
                " ".join(cmd) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{res.stderr[-4000:]}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _declare(lib)
        _lib, library_path = lib, out
        return lib


def build_log() -> str:
    """The compiler's report for the loaded library ('' before a build)."""
    if library_path is None:
        return ""
    log = library_path.with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err}")
