"""The decode step's attention op (``vidgraph_tpu_torch/ops/decode_attention
.py``) on the CPU.

The plain version is the chain of twelve ops that ``models/captioner.py::
_step_block`` ran before the op existed, bit for bit (output and the cache
writes), at the tiny, tiny64 and chat widths with ragged prompts and write
slots at the first, a middle and the last slot, the op adding the qkv bias
that the product added before it (float32 or already cast, as
``serving_params`` casts it); ``generate`` and
``generate_from_tokens`` give the tokens of that chain; the ``captioner.
decode`` span counts no kernel call on the CPU.  ``plan`` cuts the shapes
the decode sends as the kernel's note says, and the wrapper's checks reject
what the kernel does not take.  The kernel itself is held to the plain
version on the card (``tests/test_torch_cuda_decode_attention.py``).
"""
import math
import os

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from vidgraph_tpu_torch.core import profiling  # noqa: E402
from vidgraph_tpu_torch.models import captioner as cap  # noqa: E402
from vidgraph_tpu_torch.ops import decode_attention as da  # noqa: E402
from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient  # noqa: E402


def _chain_attention(q, k, v, kcache, vcache, write_slot, masked, dtype):
    """The attention as ``_step_block`` ran it before the op: twelve
    PyTorch ops."""
    b, _, _, hd = q.shape
    kcache[:, :, write_slot] = k[:, 0]
    vcache[:, :, write_slot] = v[:, 0]
    att = (q.float().transpose(1, 2) @ kcache.transpose(2, 3)) \
        / math.sqrt(hd)
    att = att.masked_fill(masked, -1e30)
    att = torch.softmax(att, dim=-1).to(dtype)
    o = (att.float() @ vcache).transpose(1, 2)
    return o.reshape(b, 1, -1).to(dtype)


def _chain_step_block(bp, cfg, x, kcache, vcache, write_slot, masked):
    """``_step_block`` as it was before the op."""
    d = x.shape[-1]
    q, k, v = cap._qkv(bp, cfg, x)
    o = _chain_attention(q, k, v, kcache, vcache, write_slot, masked,
                         cfg.dtype)
    x = x + cap._row_linear(o, bp["attn_o_w"], bp["attn_o_b"], cfg,
                            d).float()
    return cap._mlp(bp, cfg, x)


def _config(name):
    if name == "tiny64":
        return TPUVLMClient(preset="tiny64", max_new=8).cap_cfg
    return {"tiny": cap.CaptionerConfig.tiny(),
            "chat": cap.CaptionerConfig.chat()}[name]


def _views(qkv, h, hd):
    b = qkv.shape[0]
    return [z.reshape(b, 1, h, hd) for z in qkv.split(h * hd, dim=-1)]


def _step_inputs(cfg, b, max_t, slot, seed):
    """q, k, v as ``_step_block`` makes them (views of one bias-less
    product), the float32 qkv bias, caches whose slots hold compute-dtype
    values, and the decode loop's mask for ragged prompts: row r sees keys
    < start[r] and [decode_base, slot]."""
    g = torch.Generator().manual_seed(seed)
    h, hd = cfg.heads, cfg.width // cfg.heads
    qkv = torch.randn(b, 1, 3 * h * hd, generator=g).to(cfg.dtype)
    q, k, v = _views(qkv, h, hd)
    qkv_b = torch.randn(3 * h * hd, generator=g)
    kc, vc = (torch.randn(b, h, max_t, hd, generator=g).to(cfg.dtype)
              .float() for _ in range(2))
    decode_base = slot // 2
    start = torch.randint(0, decode_base + 1, (b,), generator=g)
    key = torch.arange(max_t)
    masked = (key[None, :] >= start[:, None])[:, None, None, :].clone()
    masked[..., decode_base:slot + 1] = False
    return q, k, v, qkv_b, kc, vc, masked


@pytest.mark.parametrize("width", ["tiny", "tiny64", "chat"])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("bias_dtype", ["float32", "compute"])
def test_plain_version_is_the_chain_bit_for_bit(width, where, bias_dtype):
    cfg = _config(width)
    max_t = 40
    slot = {"first": 0, "middle": 23, "last": max_t - 1}[where]
    q, k, v, qkv_b, kc, vc, masked = _step_inputs(cfg, 3, max_t, slot,
                                                  seed=slot)
    if bias_dtype == "compute":
        qkv_b = qkv_b.to(cfg.dtype)
    kc2, vc2 = kc.clone(), vc.clone()
    # before the op, ``_linear`` added the bias to the whole product
    raw = torch.cat([q, k, v], dim=2).reshape(3, 1, 3 * cfg.width)
    chain_qkv = _views(raw + qkv_b.to(cfg.dtype), cfg.heads,
                       cfg.width // cfg.heads)
    calls = da.REF_CALLS
    got = da.decode_attention(q, k, v, qkv_b, kc, vc, slot, masked,
                              cfg.dtype)
    assert da.REF_CALLS == calls + 1
    want = _chain_attention(*chain_qkv, kc2, vc2, slot, masked, cfg.dtype)
    assert got.dtype == cfg.dtype and got.shape == (3, 1, cfg.width)
    assert torch.equal(got, want)
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    assert torch.equal(kc[:, :, slot], chain_qkv[1][:, 0].float())


def _tiny_params():
    cfg = cap.CaptionerConfig.tiny()
    return cfg, cap.init_params(cfg, seed=5)


def _tiny64_params():
    client = TPUVLMClient(preset="tiny64", max_new=8)
    return client.cap_cfg, client._serve_params


@pytest.mark.parametrize("kind", ["generate", "generate_from_tokens"])
@pytest.mark.parametrize("preset", ["tiny", "tiny64"])
def test_decode_tokens_equal_the_chains(monkeypatch, kind, preset):
    cfg, params = _tiny_params() if preset == "tiny" else _tiny64_params()
    g = torch.Generator().manual_seed(7)
    if kind == "generate":
        vis = torch.randn(3, cfg.num_vision_tokens, cfg.vision_dim,
                          generator=g)

        def run():
            return cap.generate(params, cfg, vis, max_new=20)
    else:
        tokens = torch.randint(0, 256, (3, 9), generator=g,
                               dtype=torch.int32)
        lens = torch.tensor([9, 4, 0], dtype=torch.int32)

        def run():
            return cap.generate_from_tokens(params, cfg, tokens, lens,
                                            max_new=20)
    got = run()
    monkeypatch.setattr(cap, "_step_block", _chain_step_block)
    assert torch.equal(got, run())


def test_decode_span_counts_no_kernel_call_on_the_cpu():
    cfg, params = _tiny_params()
    vis = torch.randn(2, cfg.num_vision_tokens, cfg.vision_dim,
                      generator=torch.Generator().manual_seed(1))
    calls = da.REF_CALLS
    profiling.enable()
    try:
        toks = cap.generate(params, cfg, vis, max_new=12)
        (decode,) = [r for r in profiling.drain()
                     if r["name"] == "captioner.decode"]
    finally:
        profiling.disable()
    steps = cap.decode_steps(toks, 12)
    assert decode["counts"]["steps"] == steps
    assert decode["counts"]["attn_kernel_calls"] == 0
    assert da.REF_CALLS - calls == cfg.layers * steps


@pytest.mark.parametrize("bh,live,hd,want", [
    (16, 265, 128, (1, 265)),      # large() at B 1: ingest's shape
    (16 * 16, 265, 128, (1, 265)),  # large() at B 16
    (128, 265, 64, (1, 265)),      # base() at B 16
    (8192, 265, 128, (1, 265)),    # large() at B 512
    (8, 512, 64, (1, 512)),        # few keys: one block a head
    (8, 4096, 64, (16, 256)),      # chat() at B 1: split
    (16, 3056, 64, (12, 255)),     # chat() at B 2
    (2, 1024, 128, (8, 128)),
])
def test_plan_routes_the_decodes_shapes(bh, live, hd, want):
    assert da.plan(bh, live, hd) == want


def test_plan_covers_every_key_within_the_kernels_limits():
    for bh in (1, 2, 7, 16, 64, 131, 132, 512, 1024, 8192):
        for live in (1, 2, 137, 511, 512, 513, 1024, 4095, 4096, 4097,
                     9000, 20000):
            for hd in (4, 8, 32, 64, 80, 128, 136, 256):
                splits, chunk = da.plan(bh, live, hd)
                assert splits * chunk >= live > (splits - 1) * chunk
                if splits == 1:
                    assert live <= da.SINGLE_MAX_KEYS
                else:
                    assert chunk <= da.SINGLE_MAX_KEYS
                    assert live > da.SPLIT_MIN_KEYS or bh >= da.H100_SMS


def _valid(b=2, h=3, hd=16, max_t=12, slot=5, dtype=torch.bfloat16):
    cfg = cap.CaptionerConfig(width=h * hd, heads=h, dtype=dtype)
    q, k, v, qkv_b, kc, vc, masked = _step_inputs(cfg, b, max_t, slot,
                                                  seed=0)
    return q, k, v, qkv_b.to(dtype), kc, vc, masked, slot, dtype


def test_check_takes_the_decodes_views():
    q, k, v, qkv_b, kc, vc, masked, slot, dtype = _valid()
    assert q.stride() != q.contiguous().stride()
    da._check(q, k, v, qkv_b, kc, vc, slot, masked, dtype)


@pytest.mark.parametrize("fault", [
    "dtype", "q_dtype", "hd", "cache_dtype", "cache_strided", "mask_dtype",
    "slot_high", "slot_low", "shape", "bias_shape", "bias_dtype"])
def test_check_rejects_what_the_kernel_does_not_take(fault):
    q, k, v, qkv_b, kc, vc, masked, slot, dtype = _valid(
        hd=6 if fault == "hd" else 16)
    if fault == "dtype":
        dtype = torch.int32
    elif fault == "q_dtype":
        q = q.float()
    elif fault == "cache_dtype":
        kc = kc.to(torch.bfloat16)
    elif fault == "cache_strided":
        vc = vc.transpose(2, 3).contiguous().transpose(2, 3)
    elif fault == "mask_dtype":
        masked = masked.float()
    elif fault == "slot_high":
        slot = kc.shape[2]
    elif fault == "slot_low":
        slot = -1
    elif fault == "shape":
        k = k[:1]
    elif fault == "bias_shape":
        qkv_b = qkv_b[1:]
    elif fault == "bias_dtype":
        qkv_b = qkv_b.float()
    with pytest.raises(ValueError):
        da._check(q, k, v, qkv_b, kc, vc, slot, masked, dtype)


def test_lanes_cover_the_head_dim():
    for hd in range(4, 257, 4):
        gs = da.lanes(hd)
        chunks_a_lane = -(-(hd // 4) // gs)
        assert gs & (gs - 1) == 0 and gs <= 32 and chunks_a_lane <= 2
        assert gs * chunks_a_lane >= hd // 4
    assert [da.lanes(hd) for hd in (32, 64, 80, 128, 256)] == [8, 16, 32,
                                                               32, 32]
    assert np.all(np.diff([da.lanes(hd) for hd in range(4, 257, 4)]) >= 0)


def test_counter_slots_give_each_stream_its_own_until_full(monkeypatch):
    class Lib:
        @staticmethod
        def decode_attention_counter_slots():
            return 2

    monkeypatch.setattr(da._build, "library", lambda: Lib)
    slots = da._build.CounterSlots("decode attention",
                                   "decode_attention_counter_slots")
    assert [slots(0, s) for s in (7, 9, 7, 9)] == [0, 1, 0, 1]
    with pytest.raises(RuntimeError):
        slots(1, 7)
