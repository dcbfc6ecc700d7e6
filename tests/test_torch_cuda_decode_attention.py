"""The decode step's attention kernel (``csrc/decode_attention.cu``)
against its plain version on the card.  Marked ``cuda``: they skip on a
host without one.  Run them there with
``python -m pytest tests/test_torch_cuda_decode_attention.py -s``
(``-s`` prints the share of greedy tokens that agree).

Tolerance, ``|kernel - plain| <= abs + rel |plain|`` with
``flash_attention.tolerance`` of the compute dtype (bfloat16 0.01 + 0.02,
float16 1.25e-3 + 2.5e-3, float32 1e-5): both compute the same float32
scores, softmax and P.V and round the probabilities and the output to
the compute dtype at the same places; they differ only in the order of
the float32 sums, so a probability or an output element may round the
other way, one unit in the last place of the compute dtype.  The cache
writes, the qkv bias add included, are bit-equal.  Teacher-forced logits
of a decode through the kernel and through the plain chain agree within
0.05 (the bound PERF.md uses for batched captions).
"""
import pytest
import torch

from vidgraph_tpu_torch.core import profiling
from vidgraph_tpu_torch.models import captioner as cap
from vidgraph_tpu_torch.ops import decode_attention as da
from vidgraph_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

LOGIT_TOL = 0.05
MAX_T = 4096


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, hd, max_t, slot, dtype, seed, dev):
    """q, k, v as views of one [B, 1, 3 h hd] product (``_qkv`` without
    its bias), the bias [3 h hd], float32 caches, and the decode loop's
    mask for ragged prompts: row r sees keys < start[r] and [decode_base,
    slot]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, 1, 3 * h * hd, generator=g, device=dev).to(dtype)
    q, k, v = (z.reshape(b, 1, h, hd) for z in qkv.split(h * hd, dim=-1))
    kc, vc = (torch.randn(b, h, max_t, hd, generator=g, device=dev)
              for _ in range(2))
    decode_base = slot // 2
    start = torch.randint(0, decode_base + 1, (b,), generator=g, device=dev)
    key = torch.arange(max_t, device=dev)
    masked = (key[None, :] >= start[:, None])[:, None, None, :].clone()
    masked[..., decode_base:slot + 1] = False
    qkv_b = torch.randn(3 * h * hd, generator=g, device=dev).to(dtype)
    return q, k, v, qkv_b, kc, vc, masked


def _check(q, k, v, qkv_b, kc, vc, masked, slot, dtype, splits=None):
    """The kernel (``plan``'s route, or the keys in chunks of ceil(live /
    ``splits``), which may make fewer splits) against the plain version on
    copies of the caches; returns the kernel's output."""
    kc2, vc2 = kc.clone(), vc.clone()
    want = da.decode_attention_ref(q, k, v, qkv_b, kc2, vc2, slot, masked,
                                   dtype)
    with pytest.MonkeyPatch.context() as m:
        if splits is not None:
            chunk = -(-(slot + 1) // splits)
            m.setattr(da, "plan",
                      lambda *_: (-(-(slot + 1) // chunk), chunk))
        got = da.decode_attention(q, k, v, qkv_b, kc, vc, slot, masked,
                                  dtype)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    tol_abs, tol_rel = fa.tolerance(dtype)
    err = (got.float() - want.float()).abs()
    excess = err - (tol_abs + tol_rel * want.float().abs())
    assert float(excess.max()) <= 0, float(err.max())
    return got


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("b", [1, 16, 64, 512])
@pytest.mark.parametrize("hd", [32, 64, 80, 128])
def test_kernel_matches_plain(dev, hd, b, dtype):
    h = 2
    for live in (1, 137, 1024, MAX_T):
        _check(*_inputs(b, h, hd, MAX_T, live - 1, dtype, live + hd, dev),
               live - 1, dtype)


# the decode's own shapes: large() at B 1 (the ingest cell), base() at
# B 16, chat() at B 1 x 4,096 positions; and head dims at the domain's
# edges (a lane takes two chunks above 128)
@pytest.mark.parametrize("b,h,hd,max_t,live", [
    (1, 16, 128, 265, 265), (1, 16, 128, 265, 133), (16, 8, 64, 265, 265),
    (1, 8, 64, 4096, 4096), (1, 8, 64, 4096, 3000), (3, 3, 4, 300, 300),
    (3, 3, 8, 700, 650), (2, 3, 136, 1100, 1031), (2, 2, 256, 4096, 4096),
    (5, 3, 256, 200, 17)])
def test_decode_shapes_on_both_routes(dev, b, h, hd, max_t, live):
    for dtype in (torch.bfloat16, torch.float32):
        args = _inputs(b, h, hd, max_t, live - 1, dtype, b * live, dev)
        routes = {da.plan(b * h, live, hd)[0], 2, 7}
        if live <= da.SINGLE_MAX_KEYS:
            routes.add(1)
        outs = {s: _check(*[x.clone() for x in args], live - 1, dtype,
                          splits=s)
                for s in routes if s <= live}
        # every route rounds the same probabilities: outputs differ by the
        # float32 order of P.V's sums, one unit in the last place at most
        first = next(iter(outs.values()))
        tol_abs, tol_rel = fa.tolerance(dtype)
        for out in outs.values():
            assert bool(((out.float() - first.float()).abs() <= tol_abs
                         + tol_rel * first.float().abs()).all())


def test_two_runs_are_bit_equal(dev):
    for b, h, hd, live in ((1, 8, 64, 4096), (4, 16, 128, 265)):
        args = _inputs(b, h, hd, live, live - 1, torch.bfloat16, 3, dev)
        one = da.decode_attention(*args[:6], live - 1, args[6],
                                  torch.bfloat16)
        two = da.decode_attention(*args[:6], live - 1, args[6],
                                  torch.bfloat16)
        assert torch.equal(one, two)


def test_a_cuda_tensor_never_takes_the_plain_version(dev):
    q, k, v, qkv_b, kc, vc, masked = _inputs(2, 2, 64, 64, 10,
                                             torch.bfloat16, 0, dev)
    calls, launches = da.REF_CALLS, da.LAUNCHES["decode_attention"]
    da.decode_attention(q, k, v, qkv_b, kc, vc, 10, masked, torch.bfloat16)
    assert da.REF_CALLS == calls
    assert da.LAUNCHES["decode_attention"] == launches + 1
    with pytest.raises(ValueError):
        da.decode_attention(q.float(), k, v, qkv_b, kc, vc, 10, masked,
                            torch.bfloat16)


def _forced_logits(params, cfg, caches, start, decode_base, toks):
    """The decode's logits teacher-forced on ``toks`` [B, n]: step i feeds
    toks[:, i], as ``_decode_loop`` does, through ``cap._step_block`` (and
    so through whatever ``cap.decode_attention`` is)."""
    key = torch.arange(caches[0][0].shape[2], device=toks.device)
    masked = (key[None, :] >= start[:, None])[:, None, None, :].clone()
    out = []
    for i in range(toks.shape[1] - 1):
        pos = torch.clamp(start + i, max=cfg.max_len - 1)
        x = (params["tok_emb"][toks[:, i].long()]
             + params["pos_emb"][pos])[:, None].float()
        masked[..., decode_base + i] = False
        for bp, (kc, vc) in zip(params["blocks"], caches):
            x = cap._step_block(bp, cfg, x, kc, vc, decode_base + i, masked)
        out.append(cap._head_logits(params, cfg, x)[:, 0])
    return torch.stack(out, 1)


def _plain_on_the_card(q, k, v, qkv_b, kc, vc, slot, masked, dtype):
    return da.decode_attention_ref(q, k, v, qkv_b, kc, vc, slot, masked,
                                   dtype)


@pytest.mark.parametrize("preset", ["large", "base", "chat"])
def test_teacher_forced_logits_match_the_plain_chain(dev, monkeypatch,
                                                     preset):
    cfg = getattr(cap.CaptionerConfig, preset)()
    params = cap.serving_params(cap.init_params(
        cfg, seed=1, param_dtype=torch.bfloat16, device=dev), cfg)
    g = torch.Generator(device=dev).manual_seed(2)
    nv, max_new = cfg.num_vision_tokens, 48
    if preset == "chat":
        # ragged prompts: the split route over ~3,000 keys
        t_pad, lens = 3000, torch.tensor([3000, 1700], device=dev)
        tokens = torch.randint(0, 256, (2, t_pad), generator=g, device=dev,
                               dtype=torch.int32)

        def decode():
            return cap.generate_from_tokens(params, cfg, tokens, lens,
                                            max_new=max_new)

        def prefill():
            return cap.prefill_logits(params, cfg, tokens, max_new)[1]
        start, base = nv + lens.long(), nv + t_pad
    else:
        vis = torch.randn(2, nv, cfg.vision_dim, generator=g, device=dev)

        def decode():
            return cap.generate(params, cfg, vis, max_new=max_new)

        def prefill():
            return cap.vision_prefill(params, cfg, vis, max_new)[1]
        start = torch.full((2,), nv + 1, device=dev, dtype=torch.long)
        base = nv + 1
    calls, launches = da.REF_CALLS, da.LAUNCHES["decode_attention"]
    toks = decode()
    steps = cap.decode_steps(toks, max_new)
    assert da.LAUNCHES["decode_attention"] - launches == cfg.layers * steps
    assert da.REF_CALLS == calls
    kernel = _forced_logits(params, cfg, prefill(), start, base, toks)
    with monkeypatch.context() as m:
        m.setattr(cap, "decode_attention", _plain_on_the_card)
        plain_toks = decode()
        plain = _forced_logits(params, cfg, prefill(), start, base, toks)
    gap = float((kernel - plain).abs().max())
    agree = float((toks == plain_toks).float().mean())
    print(f"decode_attention {preset}: teacher-forced logit gap {gap:.5f}, "
          f"greedy tokens agreeing {agree:.4f} ({steps} steps)")
    assert gap <= LOGIT_TOL


def test_decode_span_counts_a_kernel_call_a_layer_and_step(dev):
    cfg = cap.CaptionerConfig.base()
    params = cap.serving_params(cap.init_params(
        cfg, seed=0, param_dtype=torch.bfloat16, device=dev), cfg)
    vis = torch.randn(4, cfg.num_vision_tokens, cfg.vision_dim, device=dev)
    launches = da.LAUNCHES["decode_attention"]
    profiling.enable()
    try:
        toks = cap.generate(params, cfg, vis, max_new=40)
        (decode,) = [r for r in profiling.drain()
                     if r["name"] == "captioner.decode"]
    finally:
        profiling.disable()
    steps = cap.decode_steps(toks, 40)
    assert decode["counts"]["steps"] == steps
    assert decode["counts"]["attn_kernel_calls"] == cfg.layers * steps \
        == da.LAUNCHES["decode_attention"] - launches
