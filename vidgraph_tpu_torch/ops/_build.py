"""Build and load the hand-written CUDA kernels under ``csrc/``.

At first use, ``nvcc`` compiles each source into an object, all sources at
once in parallel processes, and links the objects into one shared library
with a plain C interface, named by the SHA-256 of the sources
(``build/kernels/libvidgraph_kernels_<sha>.so`` at the repository root);
``ctypes`` loads it.  A library whose sources have not changed is reused.
``ptxas`` reports each kernel's registers and shared memory into the
``.log`` beside the library.

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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64 = ctypes.c_int64
    lib.cosine_score_tile_launch.argtypes = [p, p, i, i, i, i, i, p, p, p, p]
    lib.cosine_score_tile_launch.restype = i
    lib.cosine_topk_merge_launch.argtypes = [p, p, i, i, i, p, p, p]
    lib.cosine_topk_merge_launch.restype = i
    lib.cosine_tile_rows.restype = i
    lib.cosine_max_dim.restype = i
    lib.flash_attn_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.flash_attn_fwd_launch.restype = i
    lib.flash_bwd_delta_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.flash_bwd_delta_launch.restype = i
    lib.flash_bwd_fused_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i,
                                           i, i, p]
    lib.flash_bwd_fused_launch.restype = i
    lib.flash_bwd_dq_convert_launch.argtypes = [p, p, ctypes.c_longlong, i, p]
    lib.flash_bwd_dq_convert_launch.restype = i
    lib.flash_takes_head_dim.argtypes = [i]
    lib.flash_takes_head_dim.restype = i
    lib.preprocess_frames_launch.argtypes = [p, p, i, i, i, i, p, p, i, i,
                                             i, f, f, f, f, f, f, p]
    lib.preprocess_frames_launch.restype = i
    lib.preprocess_max_smem.restype = i
    lib.short_attention_launch.argtypes = [p, p, p, p, i, i, i, i64, i64,
                                           i64, p]
    lib.short_attention_launch.restype = i
    lib.short_attention_max_tokens.restype = i
    lib.short_attention_head_dim.restype = i
    lib.q8_matmul_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.q8_matmul_launch.restype = i


def _compile(srcs, out: Path) -> None:
    """One ``nvcc -c`` per source, all running at once, then the link;
    the commands and the compiler's output go to ``out``'s ``.log``."""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    nvcc = _nvcc()
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                         for src, obj in zip(srcs, objs))]
    log, failed = [], []
    for cmd, proc in procs:
        text = proc.communicate(timeout=600)[0]
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(text)
    if not failed:
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True,
                             timeout=600)
        log.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stderr)
    out.with_suffix(".log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-4000:])
    os.replace(tmp, out)


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
            _compile(srcs, out)
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
