"""The port's frame preprocessing (``ops/preprocess.py``, plain version)
against the JAX package's ``preprocess_frames`` and ``_pallas_normalize``
(interpret mode), on uint8 frames from a numpy seed.

Tolerances:
* same size, float32 affine: within 1e-6 (the same arithmetic;
  ``_pallas_normalize`` computes ``x * scale + bias`` instead of
  ``(x - mean) / std``, an ulp apart on values of unit scale);
* exact resize: within 1e-4.  ``jax.image.resize``'s triangle weights
  differ from ``_interp_matrix``'s (which the port uses, and the fast path
  of both packages) by up to 1.1e-5 from the float32 rounding of the
  filter centres (no structural difference at the borders:
  ``test_resize_weights_match_jax``), i.e. at most ~4e-5 on the output;
* fast mode (bfloat16): within 2 bf16 ulps at |out| in [2, 4), 2^-5
  (|out| < 2.2 for CLIP statistics): both packages round the height pass,
  the width pass and the bias add to bfloat16, with float32 sums in
  another order.
"""
import os

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu.ops import preprocess as jpre  # noqa: E402
from vidgraph_tpu_torch.ops import preprocess as tpre  # noqa: E402

RESIZES = [((405, 720), 224), ((240, 320), 64), ((120, 160), 224)]


def _frames(b, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                                dtype=np.uint8)


def _jax(frames, size, fast):
    return np.asarray(jpre.preprocess_frames(jnp.asarray(frames), size=size,
                                             fast=fast)).astype(np.float32)


def _port(frames, size, fast):
    return tpre.preprocess_frames(torch.from_numpy(frames), size=size,
                                  fast=fast).float().numpy()


@pytest.mark.parametrize("fast", [False, True])
def test_same_size_is_the_float32_affine(fast):
    frames = _frames(3, 224, 224, 0)
    got = tpre.preprocess_frames(torch.from_numpy(frames), 224, fast=fast)
    assert got.dtype == torch.float32 and got.shape == (3, 224, 224, 3)
    np.testing.assert_allclose(got.numpy(), _jax(frames, 224, fast),
                               rtol=0, atol=1e-6)


def test_same_size_matches_the_pallas_normalize():
    frames = _frames(2, 224, 224, 1)
    scale, bias = jpre._affine_rows(224)
    ref = np.asarray(jpre._pallas_normalize(jnp.asarray(frames), scale, bias,
                                            interpret=True))
    np.testing.assert_allclose(_port(frames, 224, False), ref, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("src,size", RESIZES)
def test_exact_resize(src, size):
    frames = _frames(2, *src, seed=sum(src))
    got = tpre.preprocess_frames(torch.from_numpy(frames), size, fast=False)
    assert got.dtype == torch.float32 and got.shape == (2, size, size, 3)
    np.testing.assert_allclose(got.numpy(), _jax(frames, size, False),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("src,size", RESIZES)
def test_fast_resize(src, size):
    frames = _frames(2, *src, seed=sum(src) + 1)
    got = tpre.preprocess_frames(torch.from_numpy(frames), size, fast=True)
    assert got.dtype == torch.bfloat16 and got.shape == (2, size, size, 3)
    ref = _jax(frames, size, True)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=tpre.TOL_FAST)
    assert np.abs(ref).max() < 2.2


@pytest.mark.parametrize("src,size", RESIZES)
def test_resize_weights_match_jax(src, size):
    """``jax.image.resize``'s weights against ``_interp_matrix``: the same
    support at every row, borders included; values within 1.1e-5."""
    for s in src:
        eye = jnp.eye(s, dtype=jnp.float32)[:, :, None, None]
        w = np.asarray(jax.image.resize(eye, (s, size, 1, 1),
                                        method="bilinear"))[:, :, 0, 0].T
        m = tpre._interp_matrix(size, s)
        np.testing.assert_array_equal(np.abs(w) > 1e-6, m > 0)
        np.testing.assert_allclose(w, m, rtol=0, atol=1.1e-5)


def test_weight_builders_are_the_jax_packages():
    for dst, src in ((224, 405), (224, 720), (64, 320), (224, 160)):
        np.testing.assert_array_equal(tpre._interp_matrix(dst, src),
                                      jpre._interp_matrix(dst, src))
    np.testing.assert_array_equal(tpre._norm_block_matrix(224, 720, 3),
                                  jpre._norm_block_matrix(224, 720, 3))


@pytest.mark.parametrize("src,size,fast", [((405, 720), 224, True),
                                           ((405, 720), 224, False),
                                           ((120, 160), 224, True),
                                           ((224, 224), 224, True)])
def test_kernel_tables_reproduce_the_plain_version(src, size, fast):
    """The kernel's windowed tables, applied in numpy as the kernel does
    (float32 sums over the taps, the same roundings), give the plain
    version's output: the tables carry every weight of the matrices."""
    frames = _frames(1, *src, seed=7)
    starts, weights, th, tw, a, b = tpre._host_tables(*src, size, fast)
    hs, ws = starts[:size], starts[size:]
    wh = weights[:size * th].reshape(size, th)
    ww = weights[size * th:].reshape(3, size, tw)
    x = frames[0].astype(np.float32)
    rows = np.stack([wh[r] @ x[hs[r]:hs[r] + th].reshape(th, -1)
                     for r in range(size)]).reshape(size, src[1], 3)
    bf = (fast and src != (size, size))
    if bf:
        rows = torch.from_numpy(rows).to(torch.bfloat16).float().numpy()
    taps = rows[:, ws[:, None] + np.arange(tw)[None, :]]   # [r, o, t, c]
    out = np.einsum("rotc,cot->roc", taps, ww)
    if bf:
        out = torch.from_numpy(out).to(torch.bfloat16).float() \
            + torch.from_numpy(a)
        out = out.to(torch.bfloat16).float().numpy()
        tol = tpre.TOL_FAST
    else:
        out = (out - a) / b
        tol = 1e-5
    ref = _port(frames, size, fast)[0]
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("src,size", RESIZES)
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("frames", [1, 5, 160])
def test_bands_cover_every_row_once(src, size, fast, frames):
    """``band_plan``: the bands of R output rows tile rows 0..S-1 once;
    each band's staged source rows hold every tap of its rows and lie
    inside the frame; R is the most rows that keep the grid at the card's
    SMs, at most ``MAX_BAND``, less only where a block would pass the
    shared memory aimed at or a band ``MAX_BAND_SOURCE_ROWS``."""
    rows, first, count, smem = tpre.band_plan(*src, size, fast, frames)
    starts, _, th, tw, _, _ = tpre._host_tables(*src, size, fast)
    hs = starts[:size]
    nb = -(-size // rows)
    assert 1 <= rows <= tpre.MAX_BAND and len(first) == len(count) == nb
    covered = np.concatenate([np.arange(size)[b * rows:(b + 1) * rows]
                              for b in range(nb)])
    np.testing.assert_array_equal(covered, np.arange(size))
    for b in range(nb):
        lo, n = int(first[b]), int(count[b])
        assert 0 <= lo and lo + n <= src[0] and n >= th
        for r in range(b * rows, min(size, (b + 1) * rows)):
            assert lo <= hs[r] and hs[r] + th <= lo + n
    bf16_out = fast and src != (size, size)
    assert smem == tpre.smem_bytes(src[1], size, rows, int(count.max()), th,
                                   tw, bf16_out)
    assert rows == 1 or (smem <= tpre.SMEM_TARGET and
                         count.max() <= tpre.MAX_BAND_SOURCE_ROWS)
    want = max(1, min(tpre.MAX_BAND, size * frames // tpre.H100_SMS))
    assert rows <= want
    if rows < want:      # one row more would pass a limit
        wider = tpre._bands(hs, th, rows + 1)[1]
        assert wider.max() > tpre.MAX_BAND_SOURCE_ROWS or tpre.smem_bytes(
            src[1], size, rows + 1, int(wider.max()), th, tw,
            bf16_out) > tpre.SMEM_TARGET


@pytest.mark.parametrize("src,size", RESIZES)
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("frames", [5, 160])
def test_band_height_pass_reproduces_the_plain_version(src, size, fast,
                                                       frames):
    """The kernel's arithmetic, band by band from the band's staged source
    rows only: the height pass takes each tap as fp16 terms (one in the
    fast mode, whose taps are bf16 values; two in the exact mode, the
    second the first's float32 remainder), each byte as the half
    1024 + b, float32 sums of their products, then takes off 1024 x the
    row's sum of the terms; its rows are rounded to bf16 in the fast
    mode.  The width pass sums its taps in float32, then the fast mode
    adds the bias to the bf16 sum and rounds again, the exact mode takes
    (sum - a) / b.  The result is ``_port``'s output within the
    tolerances of ``test_kernel_tables_reproduce_the_plain_version``."""
    frame = _frames(1, *src, seed=frames + size)
    rows, first, count, _ = tpre.band_plan(*src, size, fast, frames)
    starts, weights, th, tw, a, b = tpre._host_tables(*src, size, fast)
    hs, ws = starts[:size], starts[size:]
    wh = torch.from_numpy(weights[:size * th].reshape(size, th))
    ww = torch.from_numpy(weights[size * th:].reshape(3, size, tw))
    x = torch.from_numpy(frame[0].reshape(src[0], -1))
    bf = fast and src != (size, size)
    out_rows = []
    for bi, (lo, n) in enumerate(zip(first, count)):
        halves = (x[lo:lo + n].float() + 1024).half().float()
        for r in range(bi * rows, min(size, (bi + 1) * rows)):
            rest, terms = wh[r].clone(), []
            for _ in range(1 if fast else 2):
                terms.append(rest.half().float())
                rest = rest - terms[-1]
            acc = torch.zeros(halves.shape[1])
            tap_sum = torch.zeros(())
            for term in terms:
                for t in range(th):
                    acc = acc + term[t] * halves[hs[r] - lo + t]
                    tap_sum = tap_sum + term[t]
            y = acc - tap_sum * 1024
            out_rows.append(y.to(torch.bfloat16).float() if bf else y)
    y = torch.stack(out_rows).reshape(size, src[1], 3)
    taps = y[:, torch.from_numpy(ws[:, None] + np.arange(tw)[None, :])]
    out = torch.zeros(size, size, 3)                      # [r, o, c]
    for t in range(tw):
        out = out + ww[:, :, t].T * taps[:, :, t]
    if bf:
        out = (out.to(torch.bfloat16).float() + torch.from_numpy(a)).to(
            torch.bfloat16).float()
        tol = tpre.TOL_FAST
    else:
        out = (out - torch.from_numpy(a)) / torch.from_numpy(b)
        tol = 1e-5
    np.testing.assert_allclose(out.numpy(), _port(frame, size, fast)[0],
                               rtol=0, atol=tol)


def test_patchify_is_the_jax_packages():
    img = np.random.default_rng(3).normal(size=(2, 64, 96, 3)).astype(
        np.float32)
    got = tpre.patchify(torch.from_numpy(img), 32).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jpre.patchify(jnp.asarray(img), 32)))


def test_counts_and_rejections():
    tpre.reset_counts()
    tpre.preprocess_frames(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), 4)
    assert tpre.REF_CALLS == 1 and tpre.LAUNCHES == {"preprocess": 0}
    with pytest.raises(ValueError):
        tpre.preprocess_frames(torch.zeros((1, 8, 8, 3)), 4)
    with pytest.raises(ValueError):
        tpre.preprocess_frames(torch.zeros((1, 8, 8, 4), dtype=torch.uint8),
                               4)
