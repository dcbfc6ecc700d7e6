"""Threefry-2x32 draws in PyTorch: the benchmark's frozen copy of
``vidgraph_tpu_torch/core/prng.py``.

The port draws its seeded weights with that module.  The reference draws
the same weights again with this copy, so that it takes no weight from the
program, and a later change to the port's draws cannot move the
yardstick: if the port's draws change, its weights no longer equal the
reference's and the comparison fails.

A key is a numpy ``uint32`` array of two words.  Key operations
(``PRNGKey``, ``split``, ``fold_in``, ``flax_key``) run on the host; the
draws (``bits``, ``uniform``, ``normal``, ``truncated_normal``,
``bernoulli``, ``lecun_normal``) run on ``device`` in int64 arithmetic
masked to 32 bits, a bounded chunk of elements at a time.

The normals invert the error function with XLA's float32 ``ErfInv``
polynomial (Giles) over XLA's CPU ``log1p``, whose ``log`` is Cephes'
(Eigen's ``plog``); XLA's CPU backend contracts multiply-adds, which the
products here reproduce as a float64 product and sum rounded once to
float32.  Every operation is a correctly rounded float32 or float64
operation (the square root is taken in float64: torch's float32 root on
the host is not correctly rounded), so the card and the host draw the same
bits.
"""
from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

Key = np.ndarray
Shape = Union[int, Sequence[int]]

_MASK = 0xFFFFFFFF
# elements hashed at once, which bounds the int64/float64 temporaries of a
# draw: on the card, enough to fill it; on the host, torch's intra-op grain
# (32768), so that each of a chunk's ~400 elementwise passes runs on one
# thread from the cache (split across threads they collapse when other
# processes hold the cores, as the tests' workers do)
CARD_CHUNK = 1 << 22
HOST_CHUNK = 1 << 15
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry(k1: int, k2: int, x1: torch.Tensor, x2: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 words
    (jax/_src/prng.py:883 ``_threefry2x32_lowering``); in place on copies
    of ``x1`` and ``x2``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = x1.add(ks[0]).bitwise_and_(_MASK)
    x2 = x2.add(ks[1]).bitwise_and_(_MASK)
    rot = torch.empty_like(x2)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1.add_(x2).bitwise_and_(_MASK)
            torch.bitwise_left_shift(x2, r, out=rot).bitwise_and_(_MASK)
            x2.bitwise_right_shift_(32 - r).bitwise_or_(rot).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x2.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(_MASK)
    return x1, x2


def _key_words(key: Key) -> Tuple[int, int]:
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    return int(k[0]), int(k[1])


def _hash_indices(key: Key, start: int, stop: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry of the flat indices ``start..stop-1`` as (hi, lo) words
    (jax/_src/prng.py:989 ``iota_2x32_shape``)."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    return _threefry(*_key_words(key), idx >> 32, idx & _MASK)


# --- keys ------------------------------------------------------------------

def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` without 64-bit types: the seed as a
    32-bit word behind a zero high word (jax/_src/prng.py:816
    ``_threefry_seed``; JAX wraps a wider Python seed the same way)."""
    return np.array([0, int(seed) & _MASK], dtype=np.uint32)


def split(key: Key, num: int = 2) -> Key:
    """``jax.random.split(key, num)``: [num, 2] keys, key i the threefry
    of index i (jax/_src/prng.py:1156 ``_threefry_split_foldlike``)."""
    hi, lo = _hash_indices(key, 0, num, "cpu")
    return torch.stack([hi, lo], dim=1).numpy().astype(np.uint32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the threefry of the count pair
    (0, data) (jax/_src/prng.py:1167 ``_threefry_fold_in``)."""
    x1, x2 = _threefry(*_key_words(key), torch.tensor([0]),
                       torch.tensor([int(data) & _MASK]))
    return np.array([int(x1), int(x2)], dtype=np.uint32)


def flax_key(root: Key, path: Sequence[str], counter: int) -> Key:
    """The key Flax's ``make_rng('params')`` gives the ``counter``-th
    parameter (from 1) of the module scope at ``path`` under ``root``:
    ``root`` folded with the first four bytes, big-endian, of the SHA-1 of
    the path's names and the counter (flax/core/scope.py:110
    ``_fold_in_static``, without ``flax_fix_rng_separator``)."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], "big"))


# --- draws -----------------------------------------------------------------

def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _chunked(key: Key, shape: Shape, device, dtype, fn) -> torch.Tensor:
    """``fn(hi, lo)`` of each chunk of the flat indices, into one tensor
    of ``shape``."""
    shape = _shape(shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    chunk = HOST_CHUNK if out.device.type == "cpu" else CARD_CHUNK
    for start in range(0, n, chunk):
        stop = min(n, start + chunk)
        out[start:stop] = fn(*_hash_indices(key, start, stop, out.device))
    return out.reshape(shape)


def _fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a contracted multiply-add:
    the product of two float32 values is exact in float64.  ``a`` or
    ``b`` is a tensor."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    return a.double().mul_(b).add_(c).float()


def _unit_floats(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """[1, 2) - 1 from the top 23 of each draw's 32 bits
    (jax/_src/random.py:435 ``_uniform``)."""
    mantissa = ((hi ^ lo) >> 9) | 0x3F800000
    return mantissa.to(torch.int32).view(torch.float32) - 1.0


def _affine(floats: torch.Tensor, minval: float, maxval: float
            ) -> torch.Tensor:
    """max(lo, floats * (hi - lo) + lo) in float32, the constants as
    Python floats (a device scalar would cost a host sync a chunk)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(_fma(floats, float(hi - lo), float(lo)),
                           float(lo))


def bits(key: Key, shape: Shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values in
    [0, 2**32) (jax/_src/prng.py:1184
    ``_threefry_random_bits_partitionable``)."""
    return _chunked(key, shape, device, torch.int64,
                    lambda hi, lo: hi ^ lo)


def uniform(key: Key, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _chunked(key, shape, device, torch.float32,
                    lambda hi, lo: _affine(_unit_floats(hi, lo),
                                           minval, maxval))


def bernoulli(key: Key, p: float = 0.5, shape: Shape = (),
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: uniform < p in float32
    (jax/_src/random.py:1075 ``_bernoulli``, mode 'low')."""
    return uniform(key, shape, device=device) < float(np.float32(p))


# XLA's float32 ErfInv (Giles): coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# Cephes log1p for |x| < sqrt(2) - 1 (XLA's elemental EmitLog1p)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Cephes logf (Eigen's plog_float), XLA's CPU log
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _f32s(coeffs) -> Tuple[float, ...]:
    """The constants as the float32 values the float32 code holds."""
    return tuple(float(np.float32(c)) for c in coeffs)


_ERFINV_LT5, _ERFINV_GE5 = _f32s(_ERFINV_LT5), _f32s(_ERFINV_GE5)
_LOG1P_NUM, _LOG1P_DEN = _f32s(_LOG1P_NUM), _f32s(_LOG1P_DEN)
_LOG_P, (_LOG_Q1, _LOG_Q2) = _f32s(_LOG_P), _f32s((_LOG_Q1, _LOG_Q2))


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def _log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log of positive ``x``: frexp, the mantissa moved to
    [sqrt(1/2), sqrt(2)) - 1, Cephes' degree-8 polynomial in three groups,
    and the exponent's ln 2 in two parts."""
    x = torch.clamp_min(x, float(np.finfo(np.float32).tiny))
    word = x.view(torch.int32)
    e = ((word >> 23) - 0x7E).float()
    m = ((word & ~0x7F800000) | 0x3F000000).view(torch.float32)
    below = m < float(np.float32(0.707106781186547524))
    e = e - below.float()
    m = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = _fma(_fma(p[0], m, p[1]), m, p[2])
    y1 = _fma(_fma(p[3], m, p[4]), m, p[5])
    y2 = _fma(_fma(p[6], m, p[7]), m, p[8])
    y = _fma(_fma(_fma(y, m3, y1), m3, y2), m3, e * _LOG_Q1)
    out = _fma(m2, -0.5, m) + y
    return _fma(e, _LOG_Q2, out)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p: Cephes' rational form below sqrt(2) - 1 in
    magnitude, ``log(1 + x)`` above."""
    x2 = x * x
    small = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + _fma(-0.5, x2, (x * x2) * small)
    return torch.where(x.abs() < float(np.float32(0.41421356237309504880)),
                       small, _log(x + 1.0))


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv (chlo ``erf_inv``): Giles' polynomial in
    ``w = -log1p(-x^2)``, shifted by 2.5 below 5 and by 3 on sqrt(w)
    above; +-inf at +-1."""
    w = -_log1p(x * -x)
    lt = w < 5.0
    # a float64 root rounded to float32 is the correctly rounded float32
    # root (torch's float32 sqrt on the host is not)
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, a, b)
        p = c if p is None else _fma(p, w, c)
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_SQRT2 = float(np.float32(np.sqrt(2)))


def normal(key: Key, shape: Shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: sqrt(2) ErfInv of a
    uniform on [nextafter(-1, 0), 1) (jax/_src/random.py:867
    ``_normal_real``)."""
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    return _chunked(key, shape, device, torch.float32,
                    lambda hi, lw: _SQRT2 * _erf_inv(
                        _affine(_unit_floats(hi, lw), lo, 1.0)))


def _erf32(x: float) -> float:
    """float32 erf of a float32 argument (the two bounds of a truncated
    normal; equal to XLA's for the -2 and 2 of ``lecun_normal``)."""
    return float(np.float32(math.erf(float(np.float32(x)))))


def truncated_normal(key: Key, lower: float, upper: float, shape: Shape,
                     device=None) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``:
    sqrt(2) ErfInv of a uniform on [erf(lower/sqrt2), erf(upper/sqrt2)),
    clipped inside (lower, upper) (jax/_src/random.py:1005
    ``_truncated_normal``)."""
    a = _erf32(np.float32(lower) / np.float32(_SQRT2))
    b = _erf32(np.float32(upper) / np.float32(_SQRT2))
    lo = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))
    return _chunked(key, shape, device, torch.float32,
                    lambda h, lw: torch.clamp(_SQRT2 * _erf_inv(
                        _affine(_unit_floats(h, lw), a, b)), lo, hi))


def lecun_normal(key: Key, shape: Shape, device=None) -> torch.Tensor:
    """``jax.nn.initializers.lecun_normal()(key, shape)``: a normal
    truncated to (-2, 2) times sqrt(1 / fan_in) / 0.8796... (its standard
    deviation), fan_in the second-to-last axis
    (jax/_src/nn/initializers.py:487 ``lecun_normal``, :282
    ``variance_scaling``)."""
    shape = _shape(shape)
    stddev = (np.sqrt(np.float32(1.0 / shape[-2]))
              / np.float32(.87962566103423978))
    return truncated_normal(key, -2.0, 2.0, shape,
                            device) * float(stddev)
