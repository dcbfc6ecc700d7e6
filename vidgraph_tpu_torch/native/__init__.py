"""Native (C++) runtime helpers, loaded via ctypes.

The shared library is built on first use with the system compiler and
cached by source hash; every native entry point has a pure-numpy fallback
so the framework never hard-depends on a toolchain.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..core.logger import get_logger

logger = get_logger("native")

_SRC = Path(__file__).parent / "ngram_hash.cc"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _cache_dir() -> Path:
    d = Path(os.environ.get("VIDGRAPH_NATIVE_CACHE",
                            Path.home() / ".cache" / "vidgraph_native"))
    d.mkdir(parents=True, exist_ok=True)
    return d


def _build() -> Optional[Path]:
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _cache_dir() / f"libngram_hash_{tag}.so"
    if out.exists():
        return out
    for cxx in ("g++", "c++", "clang++"):
        try:
            subprocess.run(
                [cxx, "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(out)],
                check=True, capture_output=True, timeout=120)
            logger.info("Built native ngram hasher with %s -> %s", cxx, out)
            return out
        except (FileNotFoundError, subprocess.CalledProcessError,
                subprocess.TimeoutExpired) as e:
            logger.debug("%s build failed: %s", cxx, e)
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        path = _build()
        if path is None:
            logger.info("No C++ compiler available — using numpy fallback "
                        "for ngram hashing")
            return None
        lib = ctypes.CDLL(str(path))
        lib.ngram_counts_batch.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.ngram_counts_batch.restype = None
        _LIB = lib
    except OSError as e:
        logger.warning("Failed to load native library: %s", e)
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def ngram_counts_batch(texts: Sequence[str], n_buckets: int,
                       ns: Sequence[int] = (2, 3, 4)
                       ) -> Optional[np.ndarray]:
    """[n_texts, n_buckets] float32 log1p'd n-gram bucket counts, or None
    when the native library is unavailable (caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return None
    blobs = [t.lower().encode("utf-8", errors="replace") for t in texts]
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    blob = b"".join(blobs) or b"\x00"
    blob_arr = np.frombuffer(blob, np.uint8)
    ns_arr = np.asarray(list(ns), np.int64)
    out = np.zeros((len(blobs), n_buckets), np.float32)
    lib.ngram_counts_batch(
        blob_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(len(blobs)),
        ns_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(len(ns_arr)),
        ctypes.c_int64(n_buckets),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
