"""Build and load the hand-written CUDA kernels under ``csrc/``.

At first use, ``nvcc`` compiles each source into an object, all sources at
once in parallel processes, and links the objects into one shared library
with a plain C interface, named by the SHA-256 of the sources and the
headers beside them (``build/kernels/libvidgraph_kernels_<sha>.so`` at the
repository root);
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
    lib.cosine_score_tile_launch.argtypes = [p, p, i, i, i, i, i, i, i, i, p,
                                             p, p, p, p, i, p]
    lib.cosine_score_tile_launch.restype = i
    lib.cosine_tile_rows.restype = i
    lib.cosine_list_max_k.restype = i
    lib.cosine_counter_slots.restype = i
    lib.cosine_select_launch.argtypes = [p, i, i, i, p, p, p, i, p]
    lib.cosine_select_launch.restype = i
    lib.cosine_select_sort_cap.restype = i
    lib.cosine_queries_per_launch.argtypes = [i, i, i]
    lib.cosine_queries_per_launch.restype = i
    lib.flash_attn_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.flash_attn_fwd_launch.restype = i
    lib.flash_bwd_delta_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.flash_bwd_delta_launch.restype = i
    lib.flash_bwd_fused_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i,
                                           i, i, p]
    lib.flash_bwd_fused_launch.restype = i
    lib.flash_bwd_dq_convert_launch.argtypes = [p, p, ctypes.c_longlong, i, p]
    lib.flash_bwd_dq_convert_launch.restype = i
    lib.attn_general_fwd_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                            i, i, f, i, i, p]
    lib.attn_general_fwd_launch.restype = i
    lib.attn_general_bwd_delta_launch.argtypes = [p, p, p, p, i, i, i, i, i,
                                                  p]
    lib.attn_general_bwd_delta_launch.restype = i
    lib.attn_general_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i,
                                            i, i, i, i, f, i, i, p]
    lib.attn_general_bwd_launch.restype = i
    lib.attn_general_dq_convert_launch.argtypes = [p, p, ctypes.c_longlong,
                                                   i, f, p]
    lib.attn_general_dq_convert_launch.restype = i
    lib.preprocess_frames_launch.argtypes = [p, p, i, i, i, i, p, p, p, i,
                                             i, i, i, i, i, i, i, i, i, f,
                                             f, f, f, f, f, p]
    lib.preprocess_frames_launch.restype = i
    lib.short_attention_launch.argtypes = [p, p, p, p, i, i, i, i64, i64,
                                           i64, p]
    lib.short_attention_launch.restype = i
    lib.q8_matmul_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.q8_matmul_launch.restype = i
    lib.decode_attention_launch.argtypes = [p, p, p, i64, i64, i64, i64, i64,
                                            i64, p, p, p, p, i64, p, i, i, i,
                                            i, i, i, i, i, p, i, p]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_counter_slots.restype = i


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
        for src in sorted([*srcs, *CSRC.glob("*.cuh")]):
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


class CounterSlots:
    """The slots of one of the library's zero-initialised arrays of
    completion counters (kernels whose grid's last block merges, leaving
    its counter at zero): one slot a (device, stream), so that launches on
    different streams never share a counter.  ``capacity`` names the
    library's function that gives the array's slots."""

    def __init__(self, what: str, capacity: str):
        self._what, self._capacity = what, capacity
        self._slots: dict = {}
        self._lock = threading.Lock()

    def __call__(self, device: int, stream: int) -> int:
        slot = self._slots.get((device, stream))
        if slot is None:
            with self._lock:
                slot = self._slots.setdefault((device, stream),
                                              len(self._slots))
            if slot >= getattr(library(), self._capacity)():
                raise RuntimeError(f"{self._what} on more than {slot} "
                                   "streams: no completion counter is left")
        return slot
