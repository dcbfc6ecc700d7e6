"""The hand-written CUDA preprocessing kernel (``csrc/preprocess.cu``)
against its plain PyTorch version, on the card.  Marked ``cuda``: they skip
on a host without one.  Run them there with
``python -m pytest tests/test_torch_cuda_preprocess.py``.

Tolerances (``ops/preprocess.py``): the float32 modes within ``TOL_F32``
(1e-4; the kernel sums the filter taps in float32 in another order than
the plain version's matrix products); the bf16 mode within ``TOL_FAST``
(2 bf16 ulps at |out| in [2, 4)): both round the height pass, the width
pass and the bias add to bfloat16, so an ulp flip at the height pass can
move the output by about one ulp.
"""
import numpy as np
import pytest
import torch

from vidgraph_tpu_torch.ops import preprocess as pre

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _frames(b, h, w, seed, dev):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (b, h, w, 3), dtype=np.uint8)).to(dev)


# the shapes of chip_smoke.py phase 9, and ragged ones
@pytest.mark.parametrize("b,h,w,size,fast", [
    (5, 405, 720, 224, True), (5, 405, 720, 224, False),
    (160, 405, 720, 224, True), (5, 224, 224, 224, True),
    (5, 224, 224, 224, False), (3, 120, 160, 224, True),
    (3, 120, 160, 224, False), (2, 240, 320, 64, True), (1, 7, 9, 5, False)])
def test_kernel_matches_plain(dev, b, h, w, size, fast):
    x = _frames(b, h, w, h + w + b, dev)
    got = pre.preprocess_frames(x, size, fast)
    torch.cuda.synchronize()
    ref = pre.preprocess_ref(x, size, fast)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    tol = pre.TOL_FAST if ref.dtype == torch.bfloat16 else pre.TOL_F32
    err = float((got.float() - ref.float()).abs().max())
    assert bool(torch.isfinite(got).all()) and err <= tol, err


@pytest.mark.parametrize("b,h,w,size", [
    (1, 405, 720, 224), (160, 405, 720, 224), (1, 120, 160, 224),
    (160, 120, 160, 224), (1, 224, 224, 224), (160, 224, 224, 224),
    (5, 405, 720, 101), (3, 120, 160, 224), (7, 64, 96, 49)])
@pytest.mark.parametrize("fast", [True, False])
def test_every_band_layout(dev, b, h, w, size, fast):
    """1, 3-7 and 160 frames (bands of 1 to 8 rows), bands that do not
    divide S, output rows that are no whole number of 16-byte groups
    (S = 101, 49), and all three modes (the same-size float32 affine,
    fast, exact)."""
    rows = pre.band_plan(h, w, size, fast, b)[0]
    if (b, size) in ((5, 101), (3, 224), (7, 49)):
        assert size % rows, (rows, size)
    x = _frames(b, h, w, b + h + size, dev)
    got = pre.preprocess_frames(x, size, fast)
    torch.cuda.synchronize()
    ref = pre.preprocess_ref(x, size, fast)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    tol = pre.TOL_FAST if ref.dtype == torch.bfloat16 else pre.TOL_F32
    err = float((got.float() - ref.float()).abs().max())
    assert bool(torch.isfinite(got).all()) and err <= tol, err
    assert torch.equal(got, pre.preprocess_frames(x, size, fast))


def test_unaligned_frames_take_the_copy_by_threads(dev):
    """Frames that start 4 bytes off a 16-byte boundary: the band is copied
    by the threads, not in bulk, with the same results."""
    x = _frames(2, 405, 720, 5, dev)
    y = torch.empty(x.numel() + 4, dtype=torch.uint8,
                    device=dev)[4:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16
    for fast in (True, False):
        ref = pre.preprocess_ref(y, 224, fast)
        got = pre.preprocess_frames(y, 224, fast)
        tol = pre.TOL_FAST if fast else pre.TOL_F32
        assert float((got.float() - ref.float()).abs().max()) <= tol
        assert torch.equal(got, pre.preprocess_frames(x, 224, fast))


def test_same_size_is_exact(dev):
    """224^2 input is the 1-tap identity: the affine alone, bit for bit."""
    x = _frames(4, 224, 224, 0, dev)
    assert torch.equal(pre.preprocess_frames(x, 224, True),
                       pre.preprocess_ref(x, 224, True))


def test_launch_counts_and_no_plain_calls(dev):
    x = _frames(1, 64, 64, 0, dev)
    pre.reset_counts()
    pre.preprocess_frames(x, 32, True)
    assert pre.LAUNCHES == {"preprocess": 1} and pre.REF_CALLS == 0
    pre.preprocess_frames(x.cpu(), 32, True)
    assert pre.LAUNCHES == {"preprocess": 1} and pre.REF_CALLS == 1


def test_kernel_rejects_what_it_cannot_take(dev):
    x = _frames(1, 64, 64, 0, dev)
    with pytest.raises(ValueError):
        pre.preprocess_frames(x.transpose(1, 2), 32, True)
    with pytest.raises(ValueError):
        pre.preprocess_frames(x[:0], 32, True)


@pytest.mark.parametrize("b,h,w,size", [
    (1, 4, 5000, 32), (2, 2160, 3840, 224), (2, 3840, 2160, 224),
    (1, 4320, 7680, 224), (1, 7680, 4320, 224), (2, 1081, 1921, 224),
    (1, 1440, 2560, 224)])
@pytest.mark.parametrize("fast", [True, False])
def test_large_frames_match_plain(dev, b, h, w, size, fast):
    """Frames whose full-width band does not fit within its limits (a
    5000-px row, once refused; 1080p-odd and 1440p; 4K and 8K in either
    orientation) take strips of output columns, 4K and 8K with bands of
    more than 32 source rows."""
    x = _frames(b, h, w, h + w, dev)
    plan = pre.plan(h, w, size, fast, b)
    if h > 1000:
        assert plan.cols < size
    if (h, w) in ((2160, 3840), (3840, 2160), (4320, 7680), (7680, 4320)):
        assert plan.count.max() > 32
    got = pre.preprocess_frames(x, size, fast)
    torch.cuda.synchronize()
    ref = pre.preprocess_ref(x, size, fast)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    tol = pre.TOL_FAST if ref.dtype == torch.bfloat16 else pre.TOL_F32
    err = float((got.float() - ref.float()).abs().max())
    assert bool(torch.isfinite(got).all()) and err <= tol, err
    assert torch.equal(got, pre.preprocess_frames(x, size, fast))
