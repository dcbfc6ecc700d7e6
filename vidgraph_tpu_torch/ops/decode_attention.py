"""The attention of one decode step against the KV cache: the qkv bias
add, the cache write, the scores, the mask, the softmax and P.V in one
hand-written kernel.

It replaces no TPU kernel: the JAX package's ``_step_block``
(``vidgraph_tpu/models/captioner.py``) leaves this step to XLA, which
fuses the cache update and the two einsums.  The eager port ran it as
the bias add and twelve PyTorch ops a layer, each ~20 us of host time:
at B 1 the decode step is paced by the host's launches.
``decode_attention`` is one op in their place; ``decode_attention_ref``,
the plain version, is that chain of ops as ``models/captioner.py::
_step_block`` ran it.

For every row b and local head h (``csrc/decode_attention.cu``), after
the qkv product's bias add (q, k and v are the product's views without
it; the op adds ``qkv_b`` as ``_linear`` added it, one launch fewer a
block):

    kcache[b, h, slot] = k[b, h]; vcache[b, h, slot] = v[b, h]   float32
    s[j] = (q[b, h] . kcache[b, h, j]) / sqrt(hd)                 float32
    p = softmax(s) over the keys the row sees (masked[b, j] false),
        rounded to the compute dtype
    o[b, h] = sum_j p[j] vcache[b, h, j]                          float32

and ``o`` comes back in the compute dtype as [B, 1, h * hd], ready for
``attn_o_w``.  Keys past ``write_slot`` are masked for every row (the
decode loop's invariant), so the kernel does not read them: at the
``large()`` captioner's 265 slots it reads half of them on average.

Routes (``plan``, on the shapes alone): one block a (row, head) where
B x h fills the card's SMs or the live keys are at most ``SPLIT_MIN_KEYS``
(one launch); otherwise the keys are split over blocks (two launches: the
scores, then P.V after the global max and sum, so the probabilities are
rounded as on the single route; the grid's last block adds the splits'
float32 sums).  Both routes take any B, any local head count, any hd that
is a multiple of 4 up to 256, float32, bfloat16 or float16, and any
``max_t``.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  ``LAUNCHES["decode_attention"]`` counts the
wrapper's calls on the card (one or two kernel launches each),
``thread_launches()`` those of the calling thread, ``REF_CALLS`` the plain
version's.
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Dict, Tuple

import torch

from . import _build
from .flash_attention import DTYPE_CODES, FLOAT_TYPES

# csrc/decode_attention.cu's geometry and limits
THREADS = 512
LOADS = 8                  # 16-byte loads a lane keeps in flight
MAX_HEAD_DIM = 256
SINGLE_MAX_KEYS = 4096     # scores a block keeps in shared memory
MAX_SPLIT_ROWS = 1024      # B x h a split launch takes
# live keys up to which one block a (row, head) reads them all even where
# B x h leaves SMs idle.  On an H100 the split's device time falls under
# the single route's from 256-384 keys, but its second launch adds ~10 us
# of the host's time a call, which a decode at small B pays; the device
# time it saves is ~7 us at 512 keys (hd 128) or 1,024 (hd 64), and 3-5x
# at 2,049-4,096 keys (``compare_torch_kernels.py --jobs decode_attention``,
# ``single_device_ms`` against ``split_device_ms``)
SPLIT_MIN_KEYS = 512
H100_SMS = 132

LAUNCHES: Dict[str, int] = {"decode_attention": 0}
REF_CALLS = 0
_thread = threading.local()


def thread_launches() -> int:
    """The wrapper's calls on the card from this thread (a decode loop
    counts its own, whatever other threads launch meanwhile)."""
    return getattr(_thread, "launches", 0)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         qkv_b: torch.Tensor, kcache: torch.Tensor,
                         vcache: torch.Tensor, write_slot: int,
                         masked: torch.Tensor, dtype: torch.dtype
                         ) -> torch.Tensor:
    """Plain version, the chain of ops the eager decode ran: adds
    ``qkv_b`` [3 * h * hd] (q's, k's, v's) cast to ``dtype``, writes k and
    v [B, 1, h, hd] into the float32 caches [B, h, maxT, hd] at
    ``write_slot``, then attends q [B, 1, h, hd] over every slot under
    ``masked`` [B, 1, 1, maxT] (True where a row does not see a key):
    float32 scores over ``sqrt(hd)``, a float32 softmax rounded to
    ``dtype``, P.V summed in float32.  Returns [B, 1, h * hd] in
    ``dtype``."""
    b, _, h, hd = q.shape
    bq, bk, bv = qkv_b.to(dtype).view(3, 1, h, hd)
    q, k, v = q + bq, k + bk, v + bv
    kcache[:, :, write_slot] = k[:, 0]
    vcache[:, :, write_slot] = v[:, 0]
    att = (q.float().transpose(1, 2) @ kcache.transpose(2, 3)) \
        / math.sqrt(hd)                               # [B, h, 1, maxT]
    att = att.masked_fill(masked, -1e30)
    att = torch.softmax(att, dim=-1).to(dtype)
    o = (att.float() @ vcache).transpose(1, 2)       # [B, 1, h, hd]
    return o.reshape(b, 1, -1).to(dtype)


def lanes(hd: int) -> int:
    """Lanes that read one key row, one 16-byte chunk each: hd / 4 rounded
    up to a power of two, at most 32 (a lane then takes two chunks)."""
    gs = 1
    while gs < hd // 4 and gs < 32:
        gs *= 2
    return gs


def plan(bh: int, live: int, hd: int, sms: int = H100_SMS
         ) -> Tuple[int, int]:
    """(splits, chunk): how a step over ``live`` keys of ``bh`` = B x h
    (row, head) pairs is cut.  (1, live) is the single route, one block a
    pair: where the pairs fill the card's ``sms``, or the keys are at most
    ``SPLIT_MIN_KEYS``.  Otherwise each pair's keys are split into chunks
    of at least one round of loads (the block's groups x its loads in
    flight) and at most ``SINGLE_MAX_KEYS``, so that about two blocks run
    an SM."""
    if live <= SINGLE_MAX_KEYS and (bh >= sms or live <= SPLIT_MIN_KEYS):
        return 1, live
    chunks_a_lane = 2 if hd // 4 > 32 else 1
    per_round = THREADS // lanes(hd) * (LOADS // chunks_a_lane)
    splits = max(2, -(-live // SINGLE_MAX_KEYS),
                 min(-(-live // per_round), -(-2 * sms // bh)))
    chunk = -(-live // splits)
    return -(-live // chunk), chunk


def _check(q, k, v, qkv_b, kcache, vcache, write_slot, masked, dtype
           ) -> Tuple[tuple, tuple, tuple, tuple]:
    """Raise on what the kernel does not take; else the strides of q, k, v
    and ``masked``.  Each step calls it once a block, so it reads each
    attribute once."""
    if dtype not in FLOAT_TYPES:
        raise ValueError(f"{dtype}: the decode attention computes in "
                         "float32, bfloat16 or float16")
    shape = kcache.shape
    if len(shape) != 4:
        raise ValueError(f"kcache {tuple(shape)}: [B, h, maxT, hd]")
    b, h, max_t, hd = shape
    want = (b, 1, h, hd)
    if not (q.shape == k.shape == v.shape == want and q.dtype == dtype
            and k.dtype == dtype and v.dtype == dtype):
        raise ValueError(f"q, k, v are {q.dtype} {tuple(q.shape)}, "
                         f"{k.dtype} {tuple(k.shape)}, {v.dtype} "
                         f"{tuple(v.shape)}, not {dtype} {want}")
    qs, ks, vs, ms = q.stride(), k.stride(), v.stride(), masked.stride()
    if qs[3] != 1 or ks[3] != 1 or vs[3] != 1:
        raise ValueError("q, k, v: the head dim must be contiguous")
    if not (vcache.shape == shape and kcache.dtype == torch.float32
            and vcache.dtype == torch.float32 and kcache.is_contiguous()
            and vcache.is_contiguous()
            and not (kcache.data_ptr() | vcache.data_ptr()) % 16):
        raise ValueError(f"kcache and vcache must be contiguous float32 "
                         f"{tuple(shape)} on 16 bytes")
    if masked.shape != (b, 1, 1, max_t) or masked.dtype != torch.bool \
            or ms[3] != 1:
        raise ValueError(f"masked is {masked.dtype} "
                         f"{tuple(masked.shape)}, not bool "
                         f"{(b, 1, 1, max_t)} with contiguous keys")
    if hd % 4 or not 4 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: a multiple of 4 up to "
                         f"{MAX_HEAD_DIM}")
    if not 0 <= write_slot < max_t:
        raise ValueError(f"write_slot {write_slot} outside [0, {max_t})")
    if not (qkv_b.shape == (3 * h * hd,) and qkv_b.dtype == dtype
            and qkv_b.is_contiguous()):
        raise ValueError(f"qkv_b is {qkv_b.dtype} {tuple(qkv_b.shape)}, "
                         f"not contiguous {dtype} {(3 * h * hd,)}")
    if not (q.get_device() == k.get_device() == v.get_device()
            == qkv_b.get_device() == kcache.get_device()
            == vcache.get_device() == masked.get_device()):
        raise ValueError("the inputs must lie on one device")
    return qs, ks, vs, ms


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     qkv_b: torch.Tensor, kcache: torch.Tensor,
                     vcache: torch.Tensor, write_slot: int,
                     masked: torch.Tensor, dtype: torch.dtype
                     ) -> torch.Tensor:
    """One decode step's attention (see the module's note): the kernel for
    CUDA tensors, the plain version for CPU tensors.  q, k, v [B, 1, h, hd]
    in ``dtype`` (views at any strides but a contiguous head dim) lack the
    bias ``qkv_b`` [3 * h * hd]; the float32 caches [B, h, maxT, hd] are
    written in place at ``write_slot``; ``masked`` [B, 1, 1, maxT] bool.
    Returns [B, 1, h * hd] in ``dtype``."""
    global REF_CALLS
    if kcache.is_cuda:
        return _cuda_decode_attention(q, k, v, qkv_b, kcache, vcache,
                                      write_slot, masked, dtype)
    if kcache.device.type != "cpu":
        raise ValueError(f"no decode attention kernel for {kcache.device}")
    REF_CALLS += 1
    return decode_attention_ref(q, k, v, qkv_b, kcache, vcache, write_slot,
                                masked, dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the completion counters of split launches on a (device, stream)
_counter_slot = _build.CounterSlots("decode attention",
                                    "decode_attention_counter_slots")


def _cuda_decode_attention(q, k, v, qkv_b, kcache, vcache, write_slot,
                           masked, dtype) -> torch.Tensor:
    qkv_b = qkv_b.to(dtype)
    qs, ks, vs, ms = _check(q, k, v, qkv_b, kcache, vcache, write_slot,
                            masked, dtype)
    b, h, max_t, hd = kcache.shape
    dev = kcache.device
    live = write_slot + 1
    splits, chunk = plan(b * h, live, hd, _sm_count(dev.index))
    if splits > 1 and b * h > MAX_SPLIT_ROWS:
        raise ValueError(f"B x h = {b * h} over {MAX_SPLIT_ROWS} with "
                         f"{live} live keys: more than one block a head "
                         "would need more completion counters")
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    out = torch.empty((b, 1, h * hd), dtype=dtype, device=dev)
    scratch, slot = None, 0
    if splits > 1:
        scratch = torch.empty(b * h * (live + splits * hd),
                              dtype=torch.float32, device=dev)
        slot = _counter_slot(dev.index, stream)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qs[0], qs[2], ks[0],
            ks[2], vs[0], vs[2], qkv_b.data_ptr(), kcache.data_ptr(),
            vcache.data_ptr(), masked.data_ptr(), ms[0], out.data_ptr(), b,
            h, hd, max_t, write_slot, DTYPE_CODES[dtype], splits, chunk,
            None if scratch is None else scratch.data_ptr(), slot, stream)
    lib = _build.library()
    if dev.index == torch.cuda.current_device():
        err = lib.decode_attention_launch(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.decode_attention_launch(*args)
    _build.check(err, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    _thread.launches = thread_launches() + 1
    return out
