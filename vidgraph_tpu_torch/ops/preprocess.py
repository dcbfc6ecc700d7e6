"""Frame preprocessing: uint8 frames -> resized, CLIP-normalised images.

Counterpart of ``vidgraph_tpu/ops/preprocess.py``.  The TPU kernel there,
``_normalize_kernel`` (``pallas_call`` in ``_pallas_normalize``), maps uint8
frames to ``x / (255 std_c) - mean_c / std_c``; serving never reaches it,
since frames larger than the tower's input take ``preprocess_frames(fast=
True)`` (two bf16 XLA matmuls) and same-size frames the jnp affine.  So the
kernel here, ``preprocess_frames`` of ``csrc/preprocess.cu``, computes the
whole of ``preprocess_frames`` in one launch: uint8 [B, H, W, 3] -> the
separable antialiased triangle-filter resize -> the CLIP affine -> [B, S, S,
3], in the three modes of the JAX function:

* same size (H = W = S): float32 ``(x - 255 mean_c) / (255 std_c)``;
* ``fast=True``: bfloat16 out.  The height pass uses the bf16-rounded
  ``_interp_matrix`` and rounds its sums to bf16; the width pass uses the
  bf16-rounded ``_norm_block_matrix`` (resize weight times
  ``1 / (255 std_c)``), accumulates in float32 and rounds to bf16; then the
  bf16 bias ``-mean_c / std_c`` is added in bf16;
* ``fast=False``: float32 separable resize, then the float32 affine.

The kernel makes the same roundings as the plain version, so the two differ
only by float32 summation order.  A block computes a band of output rows of
one frame (``plan``): the band's source rows come into shared memory
once, by bulk copies; the height pass is a product on the tensor cores over
them, and the width pass reads its rows from shared memory.  Frames too
large for a full-width band (4K, 8K) take blocks of a band x a strip of
output columns that stage only their columns' bytes (``strip_plan``), so
the kernel takes any frame size, as the JAX function does.  Per-output
start offsets and tap weights are host tables built once per (source size,
output size, mode, frames) and kept on the device.  Same-size frames take
an elementwise kernel.

What bounds it on the H100: bytes.  At the serving shape (5 frames of
405 x 720 -> 224, bf16 out) it reads 4.37 MB and writes 1.51 MB: 1.8 us at
3.35 TB/s, less than the launch and this wrapper take.  The upload of the
raw frames from the host (875 KB a frame) costs more than the kernel.

Dispatch: ``preprocess_frames`` takes the plain version for a tensor on the
CPU; a CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts
kernel launches, ``REF_CALLS`` the plain version's calls.  ``patchify`` is the JAX package's, in its NHWC
``(p, p, c)`` flatten order.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _build

# CLIP pixel statistics (public constants).
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# kernel vs plain version: float32 modes to float32 summation order; the
# bf16 mode to 2 bf16 ulps at |out| in [2, 4) (|out| < 2.2 for CLIP)
TOL_F32 = 1e-4
TOL_FAST = 2 * 2.0 ** -6

LAUNCHES: Dict[str, int] = {"preprocess": 0}
REF_CALLS = 0


def reset_counts() -> None:
    global REF_CALLS
    LAUNCHES["preprocess"] = 0
    REF_CALLS = 0


@functools.lru_cache(maxsize=32)
def _interp_matrix(dst: int, src: int) -> np.ndarray:
    """1-D antialiased bilinear (triangle-kernel) interpolation matrix
    [dst, src] (the JAX package's, as it is)."""
    scale = src / dst
    support = max(1.0, scale)
    out = np.zeros((dst, src), np.float32)
    centers = (np.arange(dst) + 0.5) * scale - 0.5
    for i, center in enumerate(centers):
        lo = max(0, int(np.floor(center - support)))
        hi = min(src - 1, int(np.ceil(center + support)))
        j = np.arange(lo, hi + 1)
        w = np.maximum(0.0, 1.0 - np.abs(j - center) / support)
        s = w.sum()
        if s > 0:
            out[i, lo:hi + 1] = w / s
    return out


@functools.lru_cache(maxsize=32)
def _norm_block_matrix(dst: int, src: int, c: int) -> np.ndarray:
    """Width resize and the CLIP scale as one [src*c, dst*c] block matrix:
    ``R[(s, ch), (w, ch)] = interp[w, s] / (255 std_ch)`` (the JAX
    package's, as it is)."""
    base = _interp_matrix(dst, src)
    blocks = np.kron(base.T, np.eye(c, dtype=np.float32))
    inv_std = np.tile(1.0 / (255.0 * np.asarray(CLIP_STD, np.float32)), dst)
    return blocks * inv_std[None, :]


@functools.lru_cache(maxsize=8)
def _mean_std_255(device) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=device) * 255.0
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=device) * 255.0
    return mean, std


def _fast_bias() -> np.ndarray:
    """``-mean_c / std_c`` in float32, per channel."""
    return (-np.asarray(CLIP_MEAN, np.float32)
            / np.asarray(CLIP_STD, np.float32))


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


@functools.lru_cache(maxsize=32)
def _ref_matrices(h: int, w: int, size: int, c: int, fast: bool,
                  device: torch.device):
    """The plain version's resize matrices on ``device``, kept: bf16
    (height, width-and-scale, bias) when ``fast``, else float32 (height,
    width)."""
    if fast:
        return (_bf16(_interp_matrix(size, h)).to(device),
                _bf16(_norm_block_matrix(size, w, c)).to(device),
                _bf16(np.tile(_fast_bias(), size)).to(device))
    return (torch.from_numpy(_interp_matrix(size, h)).to(device),
            torch.from_numpy(_interp_matrix(size, w)).to(device))


def preprocess_ref(frames_u8: torch.Tensor, size: int = 224,
                   fast: bool = False) -> torch.Tensor:
    """Plain version: ``vidgraph_tpu.ops.preprocess.preprocess_frames`` in
    PyTorch ops (matrix products for the resize)."""
    x = frames_u8
    b, h, w, c = x.shape
    dev = x.device
    if (h, w) == (size, size):
        mean, std = _mean_std_255(dev)
        return (x.float() - mean) / std
    if fast:
        rh, r2, bias = _ref_matrices(h, w, size, c, True, dev)
        y = torch.einsum("hs,bswc->bhwc", rh.float(),
                         x.float()).to(torch.bfloat16)
        y2 = (y.reshape(b, size, w * c).float() @ r2.float()) \
            .to(torch.bfloat16)
        return (y2 + bias).reshape(b, size, size, c)
    rh, rw = _ref_matrices(h, w, size, c, False, dev)
    y = torch.einsum("hs,bswc->bhwc", rh, x.float())
    y = torch.einsum("vw,bhwc->bhvc", rw, y)
    mean, std = _mean_std_255(dev)
    return (y - mean) / std


def preprocess_frames(frames_u8: torch.Tensor, size: int = 224,
                      fast: bool = False) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, size, size, 3], CLIP-normalised: bfloat16
    when ``fast`` and resizing, float32 otherwise.  The CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    global REF_CALLS
    if frames_u8.dim() != 4 or frames_u8.shape[-1] != 3:
        raise ValueError(f"frames {tuple(frames_u8.shape)} must be "
                         "[B, H, W, 3]")
    if frames_u8.dtype != torch.uint8:
        raise ValueError(f"frames are {frames_u8.dtype}; uint8 expected")
    if frames_u8.device.type == "cpu":
        REF_CALLS += 1
        return preprocess_ref(frames_u8, size, fast)
    if frames_u8.device.type != "cuda":
        raise ValueError(f"no preprocess kernel for {frames_u8.device}")
    return _cuda_preprocess(frames_u8, size, fast)


def _windows(m: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A dense [dst, src] weight matrix as per-row windows of one width:
    (start [dst] int32, weights [dst, taps]).  A window that would run
    past the source is shifted left, so every tap reads inside it."""
    dst, src = m.shape
    nz = m != 0
    lo = nz.argmax(axis=1)
    hi = src - 1 - nz[:, ::-1].argmax(axis=1)
    taps = int((hi - lo + 1).max())
    start = np.minimum(lo, src - taps).astype(np.int32)
    idx = start[:, None] + np.arange(taps)[None, :]
    return start, np.take_along_axis(m, idx, axis=1)


def _host_tables(h: int, w: int, size: int, fast: bool):
    """(int32 starts [2 size], float32 weights, h_taps, w_taps, a, b) for
    the kernel: height windows, then width windows per channel [3, size,
    taps]; ``a, b`` the per-channel affine constants."""
    same = (h, w) == (size, size)
    if same or not fast:
        mh, mw = _interp_matrix(size, h), _interp_matrix(size, w)
        mw = np.stack([mw] * 3)
    else:
        mh = _bf16(_interp_matrix(size, h)).float().numpy()
        r2 = _bf16(_norm_block_matrix(size, w, 3)).float().numpy()
        r2 = r2.reshape(w, 3, size, 3)
        mw = np.stack([r2[:, ch, :, ch].T for ch in range(3)])
    hs, hw = _windows(mh)
    ws, ww = _windows(np.concatenate(list(mw)))
    ws = ws[:size]   # the channels share one window layout
    ww = ww.reshape(3, size, -1)
    if fast and not same:
        a = _bf16(_fast_bias()).float().numpy()
        b = np.ones(3, np.float32)
    else:
        a = np.asarray(CLIP_MEAN, np.float32) * np.float32(255.0)
        b = np.asarray(CLIP_STD, np.float32) * np.float32(255.0)
    starts = np.concatenate([hs, ws]).astype(np.int32)
    weights = np.concatenate([hw.ravel(), ww.ravel()]).astype(np.float32)
    return starts, weights, hw.shape[1], ww.shape[2], a, b


# the kernel's launch shape (csrc/preprocess.cu): output rows a band at
# most, source rows a band at most in a full-width plan (two product steps),
# the shared memory a block aims under (two blocks an SM of an H100: faster
# than three with smaller bands, PERF.md), the most it may take, and the
# output columns a strip is a multiple of (16-byte output runs)
MAX_BAND = 8
MAX_BAND_SOURCE_ROWS = 32
SMEM_TARGET = 113 * 1024
SMEM_MAX = 227 * 1024
STRIP_COLS = 8
H100_SMS = 132


class Plan(NamedTuple):
    """A launch's blocks: bands of ``rows`` output rows (``first`` source
    row and source row ``count`` of each) x strips of ``cols`` output
    columns (the staged bytes ``lo[s]:hi[s]`` of a source row of each),
    and the shared bytes of a block."""
    rows: int
    first: np.ndarray
    count: np.ndarray
    cols: int
    lo: np.ndarray
    hi: np.ndarray
    smem: int


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def row_stride(wc: int) -> int:
    """The kernel's shared row stride for a source row of ``wc`` bytes:
    past its last 32-byte chunk, and 16 modulo 32 (distinct banks for the
    four rows a product fragment reads)."""
    return -(-wc // 32) * 32 + 16


def _bands(hs: np.ndarray, th: int, rows: int) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """Bands of ``rows`` consecutive output rows: (first source row [nb],
    source rows [nb]) int32, the source rows that hold every tap of the
    band's rows (``hs[r] .. hs[r] + th - 1``)."""
    size = len(hs)
    first, count = [], []
    for r0 in range(0, size, rows):
        band = hs[r0:r0 + rows]
        lo, hi = int(band.min()), int(band.max()) + th
        first.append(lo)
        count.append(hi - lo)
    return np.asarray(first, np.int32), np.asarray(count, np.int32)


def _strips(ws: np.ndarray, tw: int, cols: int, wc: int
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Strips of ``cols`` consecutive output columns: (first staged byte,
    byte past the last) of a source row, int32, the 16-byte aligned span
    (cut at the row's end) of every width tap of the strip's columns."""
    c0 = np.arange(0, len(ws), cols)
    c1 = np.minimum(c0 + cols, len(ws)) - 1
    lo = 3 * ws[c0] // 16 * 16
    hi = np.minimum(wc, -(-3 * (ws[c1] + tw) // 16) * 16)
    return lo.astype(np.int32), hi.astype(np.int32)


def smem_bytes(w: int, size: int, rows: int, band_rows: int, th: int,
               tw: int, bf16_out: bool, cols: Optional[int] = None,
               strip_bytes: Optional[int] = None) -> int:
    """Shared memory of one block (``csrc/preprocess.cu``'s layout): the
    band's source rows of a strip (then its output, staged for the copy
    out), the height-pass rows (bf16 where the output is), the strip's
    width taps and starts, the height taps and starts, the height
    product's fragments in a strip plan (strips narrower than the row, or
    bands of more than ``MAX_BAND_SOURCE_ROWS`` source rows), a barrier.
    A strip is the whole row by default."""
    cols = size if cols is None else cols
    sb = 3 * w if strip_bytes is None else strip_bytes
    ls, elem = row_stride(sb), 2 if bf16_out else 4
    staged = max(band_rows * ls, rows * cols * 3 * elem)
    frags = 0
    if cols < size or band_rows > MAX_BAND_SOURCE_ROWS:
        frags = -(-band_rows // 16) * (1 if bf16_out else 2) * 4 * 32 * 4
    return (_round16(staged) + rows * ls * elem + 3 * cols * tw * 4
            + cols * 4 + rows * th * 4 + rows * 4 + frags + 16)


def band_plan(h: int, w: int, size: int, fast: bool, frames: int,
              sms: int = H100_SMS):
    """The full-width plan: (rows a band, first source row [nb], source
    rows [nb], shared bytes) for ``frames`` frames: as many output rows a
    band as keep the grid (bands x frames) at least ``sms`` blocks, at
    most ``MAX_BAND``, and fewer where a block would pass ``SMEM_TARGET``
    or a band ``MAX_BAND_SOURCE_ROWS`` source rows (two product steps of
    16).  At one row it is returned even where it passes them; ``plan``
    then takes strips."""
    starts, _, th, tw, _, _ = _host_tables(h, w, size, fast)
    hs = starts[:size]
    bf16_out = fast and (h, w) != (size, size)
    rows = max(1, min(MAX_BAND, size * frames // sms))
    while True:
        first, count = _bands(hs, th, rows)
        smem = smem_bytes(w, size, rows, int(count.max()), th, tw, bf16_out)
        if rows == 1 or (smem <= SMEM_TARGET
                         and count.max() <= MAX_BAND_SOURCE_ROWS):
            return rows, first, count, smem
        rows -= 1


def strip_plan(h: int, w: int, size: int, fast: bool) -> Plan:
    """Bands of up to ``MAX_BAND`` rows x strips of a multiple of
    ``STRIP_COLS`` columns: of the blocks within ``SMEM_TARGET`` (else
    ``SMEM_MAX``), the shape that stages the fewest source bytes a frame
    (the height product's work goes with them), the larger block on a
    tie."""
    starts, _, th, tw, _, _ = _host_tables(h, w, size, fast)
    hs, ws = starts[:size], starts[size:]
    bf16_out = fast and (h, w) != (size, size)
    widths = sorted({min(c, size) for c in
                     range(STRIP_COLS, size + STRIP_COLS, STRIP_COLS)})
    for limit in (SMEM_TARGET, SMEM_MAX):
        best, best_key = None, None
        for rows in range(1, MAX_BAND + 1):
            first, count = _bands(hs, th, rows)
            for cols in widths:
                lo, hi = _strips(ws, tw, cols, 3 * w)
                smem = smem_bytes(w, size, rows, int(count.max()), th, tw,
                                  bf16_out, cols, int((hi - lo).max()))
                if smem > limit:
                    break            # wider strips only take more
                key = (int(count.sum()) * int((hi - lo).sum()),
                       -rows * cols)
                if best_key is None or key < best_key:
                    best_key = key
                    best = Plan(rows, first, count, cols, lo, hi, smem)
        if best is not None:
            return best
    raise ValueError(f"{h} x {w} -> {size}: a block of one output row and "
                     f"{STRIP_COLS} columns needs more than {SMEM_MAX} "
                     "bytes of shared memory")


def full_plan(h: int, w: int, size: int, fast: bool, frames: int,
              sms: int = H100_SMS) -> Plan:
    """``band_plan`` as a ``Plan`` of one strip, the whole row."""
    rows, first, count, smem = band_plan(h, w, size, fast, frames, sms)
    one = np.zeros(1, np.int32)
    return Plan(rows, first, count, size, one, one + 3 * w, smem)


@functools.lru_cache(maxsize=64)
def plan(h: int, w: int, size: int, fast: bool, frames: int,
         sms: int = H100_SMS) -> Plan:
    """The kernel's blocks for ``frames`` frames of ``h x w`` -> ``size``:
    ``full_plan`` where it keeps within its limits
    (``MAX_BAND_SOURCE_ROWS`` source rows a band, ``SMEM_TARGET`` bytes),
    else ``strip_plan``.  (A one-row band past ``SMEM_TARGET``, as at 1080p
    and 1440p, runs slower than the strips on an H100: the ``plans`` job
    of ``scripts/compare_torch_kernels.py`` times both.)"""
    full = full_plan(h, w, size, fast, frames, sms)
    if (full.count.max() <= MAX_BAND_SOURCE_ROWS
            and full.smem <= SMEM_TARGET):
        return full
    return strip_plan(h, w, size, fast)


@functools.lru_cache(maxsize=64)
def _tables(h: int, w: int, size: int, fast: bool, frames: int,
            device: torch.device, strips: Optional[bool] = None):
    """``_host_tables`` and the plan on ``device``, kept: (starts, weights
    (the width taps output-major), bands [first..., rows..., lo..., hi...],
    th, tw, a, b, the plan, its most source rows a band, its widest
    strip's bytes).  The plan is ``plan``'s, or where ``strips`` is given,
    ``strip_plan`` (True) or ``full_plan`` (False)."""
    starts, weights, th, tw, a, b = _host_tables(h, w, size, fast)
    if strips is None:
        p = plan(h, w, size, fast, frames)
    elif strips:
        p = strip_plan(h, w, size, fast)
    else:
        p = full_plan(h, w, size, fast, frames)
    bands = np.concatenate([p.first, p.count, p.lo, p.hi]).astype(np.int32)
    # the width taps output-major, [size 3][tw], as the kernel reads them
    ww = weights[size * th:].reshape(3, size, tw).transpose(1, 0, 2)
    weights = np.concatenate([weights[:size * th], ww.ravel()])
    return (torch.from_numpy(starts).to(device),
            torch.from_numpy(weights).to(device),
            torch.from_numpy(bands).to(device), th, tw, a, b, p,
            int(p.count.max()), int((p.hi - p.lo).max()))


def _cuda_preprocess(x: torch.Tensor, size: int, fast: bool,
                     strips: Optional[bool] = None) -> torch.Tensor:
    """The kernel's launch; ``strips`` forces a plan (``_tables``), for
    ``compare_torch_kernels.py``'s ``plans`` job."""
    b, h, w, c = x.shape
    if not x.is_contiguous():
        raise ValueError("frames must be contiguous")
    if b == 0 or b > 65535:
        raise ValueError(f"B = {b}: the kernel takes 1..65535 frames")
    bf16_out = fast and (h, w) != (size, size)
    (starts, weights, bands, th, tw, a, bb, p, most,
     strip_bytes) = _tables(h, w, size, fast, b, x.device, strips)
    lib = _build.library()
    out = torch.empty((b, size, size, c), device=x.device,
                      dtype=torch.bfloat16 if bf16_out else torch.float32)
    f = ctypes.c_float
    with torch.cuda.device(x.device):
        _build.check(lib.preprocess_frames_launch(
            x.data_ptr(), out.data_ptr(), b, h, w, size,
            starts.data_ptr(), weights.data_ptr(), bands.data_ptr(), th, tw,
            p.rows, len(p.first), most, p.cols, len(p.lo), strip_bytes,
            p.smem, int(bf16_out),
            f(a[0]), f(a[1]), f(a[2]), f(bb[0]), f(bb[1]), f(bb[2]),
            torch.cuda.current_stream().cuda_stream), "preprocess_frames")
        LAUNCHES["preprocess"] += 1
    return out


def patchify(images: torch.Tensor, patch: int = 32) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)(W/p), p p C], each patch flattened in
    ``(p, p, c)`` order (the JAX package's; ``unfold`` would reorder)."""
    b, h, w, c = images.shape
    nh, nw = h // patch, w // patch
    x = images.reshape(b, nh, patch, nw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, nh * nw, patch * patch * c)
