"""Byte-level decoder with a vision prefix: the on-device chat LM.

Counterpart of ``vidgraph_tpu/models/captioner.py``, as plain functions over
a parameter dict with the JAX tree's keys (``tok_emb``, ``pos_emb``,
``blocks/<i>/qkv_w`` ...), so that ``models/checkpoint.py`` reads and writes
the JAX package's npz as it is.  Ported: the full-sequence ``forward``
(differentiable w.r.t. every float leaf, with ``remat`` and ``flash`` as
in the JAX package: what ``models/train.py`` and the trainer scripts
train through), the prefill and the KV-cached greedy decode behind
``generate_from_tokens`` (the chat LM, ``backend.llm: tpu``) and
``generate`` (the vision-prefix caption decode, ``backend.vlm: tpu``),
with float or int8 (``Q8``, ``models/quant8.py``) block matrices.

Training keeps float32 master weights and computes in ``cfg.dtype``:
``wdot`` casts a weight at every call, so autograd carries the cast back
to the float32 leaf (do not train through ``serving_params``).

Numerics follow the JAX package: the residual stream stays float32, layer
norms run in float32, biases are cast to the compute dtype before they are
added, products take compute-dtype operands with float32 accumulation
(``wdot``), attention scores and softmax are float32, and GELU is the tanh
approximation (``jax.nn.gelu``'s default).

Choices of the port, none visible in the outputs beyond float32
rounding:

* The prefill's attention is ``ops/flash_attention.py``: with
  ``flash=True`` on the card the CUDA kernel (under autograd its backward
  kernels too), otherwise the plain version.
  The kernel takes any T, so the TPU's ``flash_pad_len`` padding is gone.
  ``generate``'s prefill (the nv vision slots and BOS) takes it by
  default, where the JAX package runs the einsum path; its mask is the
  kernel's ``c <= max(r, nv - 1)``.
* The KV caches are float32 tensors [B, h, maxT, hd] (head-major, so that
  the decode step's products batch over B x h without a copy), written in
  place.  They hold the compute-dtype K/V exactly, so the decode step's
  float32 scores equal those of the JAX package's bf16 caches.
* The decode loop stops once every row has emitted EOS: a done row emits
  EOS at every later step of the JAX package's static scan, so the tokens
  are the same (checked every ``_DONE_CHECK`` steps, one host sync each).
* Tensor parallelism (``parallel/``): a tree of one rank's slices
  (``models/train.py::shard_captioner``) holds a block's local heads in
  ``qkv_w`` [d, 3 d/m] and its local MLP hidden in ``fc1_w`` [d, 4 d/m];
  the code reads the split from those widths.  Inside ``use_mesh`` the
  block runs its local heads and hidden columns and all-reduces over
  "model" once after ``attn_o`` and once after ``fc2``; each reduces
  float32 partial sums, and the replicated bias is added once after it.
  The KV caches hold the local heads.  Every rank of the group leaves
  the decode at the same step: the all-done check is reduced over the
  group.
* The decode is bound by the host's kernel launches (eager PyTorch, one
  step at a time), so a step launches as few as it can: the layer norm is
  ``F.layer_norm``, the decode mask is updated in place once a step,
  ``serving_params`` casts the matrices and biases that every product
  casts anyway to the compute dtype once, not once a step, and a block's
  attention (the qkv bias add, cache writes, scores, mask, softmax, P.V)
  is one call of ``ops/decode_attention.py``: one kernel on the card,
  where the plain chain it replaces launched the bias add and twelve
  ops.  The ``captioner.decode`` span counts those kernel calls
  (``attn_kernel_calls``: the op's launches in the decode's thread
  while it ran).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core import prng, profiling
from ..ops.decode_attention import decode_attention
from ..ops.decode_attention import thread_launches as attn_thread_launches
from ..ops.flash_attention import flash_attention
from ..parallel import comm
from ..parallel.mesh import (MODEL_AXIS, active_group, active_mesh,
                             axis_group)
from .checkpoint import tree_leaves
from .quant8 import is_q8, wdot
from .tokenizer import BOS_ID, EOS_ID, PAD_ID, VOCAB_SIZE

_DONE_CHECK = 16


@dataclasses.dataclass(frozen=True)
class CaptionerConfig:
    width: int = 512
    layers: int = 8
    heads: int = 8
    vocab: int = VOCAB_SIZE
    vision_dim: int = 512
    num_vision_tokens: int = 8     # prefix slots per chunk (frames pooled in)
    max_len: int = 1024            # prefix + generated bytes
    dtype: Any = torch.bfloat16
    qmode: str = "a16"             # int8 dot mode when served quantized

    @classmethod
    def base(cls) -> "CaptionerConfig":
        """The caption decoder of ``backend.vlm: tpu``."""
        return cls()

    @classmethod
    def large(cls) -> "CaptionerConfig":
        """The serving-scale captioner: 24 x 2048, 16 heads, 1.21B
        parameters (2.4 GB in bfloat16; draw it with
        ``param_dtype=torch.bfloat16``).  int8 serving
        (``models/quant8.py``) exists for this width."""
        return cls(width=2048, layers=24, heads=16)

    @classmethod
    def chat(cls) -> "CaptionerConfig":
        """The in-process chat LM (``backend.llm: tpu``): base width with
        a 4096-position context for full pipeline prompts."""
        return cls(max_len=4096)

    @classmethod
    def tiny(cls) -> "CaptionerConfig":
        return cls(width=32, layers=2, heads=2, vision_dim=32,
                   num_vision_tokens=2, max_len=64, dtype=torch.float32)

    @property
    def num_params(self) -> int:
        """Analytic parameter count (matches init_params exactly)."""
        d, v = self.width, self.vocab
        per_block = (4 * d + 3 * d * d + 3 * d + d * d + d
                     + 4 * d * d + 4 * d + 4 * d * d + d)
        return (v * d + self.max_len * d + self.vision_dim * d + d
                + 2 * d + d * v + self.layers * per_block)


def init_params(cfg: CaptionerConfig, seed: int = 0,
                param_dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None,
                requires_grad: bool = False) -> Dict:
    """The JAX package's ``init_params(cfg, seed, param_dtype)``: the same
    numbers, drawn on ``device`` (the CPU when None) by ``core/prng.py``
    from ``split(PRNGKey(seed), 8 + 8 x layers)`` in the JAX tree's order:
    matrices N(0, 1) x 0.02 in float32, then cast to ``param_dtype``;
    layer-norm scales one, biases zero (float32).  ``requires_grad`` marks
    every leaf for training (``trainable``)."""
    keys = iter(prng.split(prng.PRNGKey(seed), 8 + cfg.layers * 8))
    d, v = cfg.width, cfg.vocab

    def dense(*shape):
        w = prng.normal(next(keys), shape, device=device) * 0.02
        return w.to(dtype=param_dtype)

    def full(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=device)

    p: Dict[str, Any] = {
        "tok_emb": dense(v, d),
        "pos_emb": dense(cfg.max_len, d),
        "vis_proj_w": dense(cfg.vision_dim, d),
        "vis_proj_b": full(d, 0.0),
        "ln_f_scale": full(d, 1.0),
        "ln_f_bias": full(d, 0.0),
        "head_w": dense(d, v),
        "blocks": [],
    }
    for _ in range(cfg.layers):
        p["blocks"].append({
            "ln1_scale": full(d, 1.0), "ln1_bias": full(d, 0.0),
            "qkv_w": dense(d, 3 * d), "qkv_b": full(3 * d, 0.0),
            "attn_o_w": dense(d, d), "attn_o_b": full(d, 0.0),
            "ln2_scale": full(d, 1.0), "ln2_bias": full(d, 0.0),
            "fc1_w": dense(d, 4 * d), "fc1_b": full(4 * d, 0.0),
            "fc2_w": dense(4 * d, d), "fc2_b": full(d, 0.0),
        })
    return trainable(p) if requires_grad else p


def trainable(params: Dict) -> Dict:
    """``params`` with every leaf marked as requiring a gradient, in
    place; returns it.  A quantised (``Q8``) leaf is not trainable and
    raises: train the float tree and quantise for serving afterwards."""
    for key, leaf in tree_leaves(params):
        if is_q8(leaf):
            raise ValueError(f"{key} is int8 (Q8): a quantised tree is for "
                             "serving, not for training")
        leaf.requires_grad_(True)
    return params


def flash_engaged(requested: bool, device: Any = None) -> bool:
    """Whether ``flash=requested`` will run the CUDA kernels: on a CUDA
    ``device`` (default: ``core.platform.device()``) it does; on the CPU
    ``forward`` takes the plain attention, which materialises the
    [B, h, T, T] probabilities.  Trainers derive their remat decision from
    this and not from the flag alone (the JAX package's ``flash_engaged``
    asks for a TPU in the same way)."""
    if device is None:
        from ..core.platform import device as default_device

        device = default_device()
    engaged = bool(requested) and torch.device(device).type == "cuda"
    if requested and not engaged:
        warnings.warn(
            f"flash attention requested but the device is '{device}' (not "
            "CUDA): taking the masked-einsum path; enable remat or expect "
            "to run out of memory at scale", RuntimeWarning, stacklevel=2)
    return engaged


def quantize_params(params: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """The float matrices (two or more dimensions) of ``params`` cast to
    ``dtype``; layer-norm and bias vectors, and ``Q8`` leaves, stay as
    they are.  For a float32 checkpoint that is to be served."""
    if isinstance(params, dict):
        return {k: quantize_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [quantize_params(v, dtype) for v in params]
    if isinstance(params, torch.Tensor) and params.dim() >= 2:
        return params.to(dtype)
    return params


def serving_params(params: Dict, cfg: CaptionerConfig) -> Dict:
    """``params`` with the product weights and biases (the block
    matrices, their biases and ``head_w``) cast to ``cfg.dtype`` once:
    ``wdot`` and ``_linear`` cast them to it at every call anyway, so the
    outputs are the same.  Embeddings and layer norms keep their dtype,
    and a quantised (``Q8``) matrix passes through untouched."""
    def cast(k, v):
        if is_q8(v) or not k.endswith(("_w", "_b")):
            return v
        return v.to(cfg.dtype)
    return {**params, "head_w": cast("head_w", params["head_w"]),
            "blocks": [{k: cast(k, v) for k, v in bp.items()}
                       for bp in params["blocks"]]}


def _ln(x, scale, bias, eps=1e-5):
    """Layer norm over the last dim in float32 (biased variance, eps
    1e-5), as the JAX package's ``_ln``."""
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def _linear(x, w, b, cfg: CaptionerConfig):
    """``wdot(x, w) + b`` with the bias cast to the compute dtype."""
    return wdot(x, w, cfg.dtype, cfg.qmode) + b.to(cfg.dtype)


def _shape(w) -> torch.Size:
    return w.q.shape if is_q8(w) else w.shape


def _column_input(y, w, full: int):
    """``y``, marked as the input of a column-split product when ``w``
    holds fewer than ``full`` output columns (the gradient is then
    all-reduced over "model")."""
    if _shape(w)[1] < full:
        return comm.copy_to(y, active_group(MODEL_AXIS, "captioner weights"))
    return y


def _row_linear(x, w, b, cfg: CaptionerConfig, full: int):
    """``_linear`` of a row-split product: ``w`` holds this rank's rows
    (fewer than ``full``), so the float32 partial sums are all-reduced
    over "model" before the cast and the bias."""
    if _shape(w)[0] == full:
        return _linear(x, w, b, cfg)
    part = x.to(cfg.dtype).float() @ w.to(cfg.dtype).float()
    group = active_group(MODEL_AXIS, "captioner weights")
    return comm.reduce_from(part, group).to(cfg.dtype) + b.to(cfg.dtype)


def _mlp(bp, cfg: CaptionerConfig, x):
    """Second half of a block: x + fc2(gelu(fc1(ln2(x))))."""
    d = x.shape[-1]
    y = _ln(x, bp["ln2_scale"], bp["ln2_bias"]).to(cfg.dtype)
    y = _column_input(y, bp["fc1_w"], 4 * d)
    hdn = F.gelu(_linear(y, bp["fc1_w"], bp["fc1_b"], cfg),
                 approximate="tanh")
    return x + _row_linear(hdn, bp["fc2_w"], bp["fc2_b"], cfg,
                           4 * d).float()


def _qkv(bp, cfg: CaptionerConfig, x):
    """q, k, v [B, T, h, hd] in the compute dtype (views of one product);
    h is the rank's local heads under tensor parallelism."""
    b, t, d = x.shape
    hd = d // cfg.heads
    y = _ln(x, bp["ln1_scale"], bp["ln1_bias"]).to(cfg.dtype)
    y = _column_input(y, bp["qkv_w"], 3 * d)
    qkv = _linear(y, bp["qkv_w"], bp["qkv_b"], cfg)
    width = qkv.shape[-1] // 3
    return [z.reshape(b, t, width // hd, hd)
            for z in qkv.split(width, dim=-1)]


def _attn_masked(q, k, v, mask):
    """Plain attention under an additive float32 ``mask`` of shape [T, T],
    [B, 1, 1, T] or [B, 1, T, T] (0 where a key is seen, -1e30 where it
    is not), as the JAX package's einsum path computes it: float32 scores
    of the compute-dtype q and k over ``sqrt(hd)``, the mask added, a
    float32 softmax cast to the compute dtype, P.V summed in float32.
    q, k, v [B, T, h, hd]; returns [B, T, h, hd] float32."""
    att = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    att = att + (mask if mask.dim() == 4 else mask[None, None])
    att = torch.softmax(att, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", att.float(), v.float())


def _block(bp, cfg: CaptionerConfig, x, flash: bool = False, mask=None):
    """Full-sequence block over x [B, T, d], and the [B, T, h, hd] k and v
    it computed.  Without ``mask`` the attention takes the causal +
    vision-prefix pattern (``ops/flash_attention.py``: the CUDA kernel
    when ``flash`` on the card); with an additive ``mask`` (the
    bidirectional encoders' per-example padding mask, [B, 1, 1, T]) it is
    the masked plain attention, whatever ``flash`` says."""
    b, t, d = x.shape
    q, k, v = (z.contiguous() for z in _qkv(bp, cfg, x))
    if mask is not None:
        o = _attn_masked(q, k, v, mask)
    else:
        o = flash_attention(q, k, v, cfg.num_vision_tokens, flash=flash)
    o = o.reshape(b, t, -1).to(cfg.dtype)
    x = x + _row_linear(o, bp["attn_o_w"], bp["attn_o_b"], cfg, d).float()
    return _mlp(bp, cfg, x), k, v


def encode_pooled(enc: Dict, cfg: CaptionerConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """The bidirectional encoder trunk of the text embedder and the
    cross-encoder: tokens [B, T] (right-padded with PAD_ID) through the
    blocks of ``enc`` under the per-example padding mask, the final layer
    norm, and the mean over the non-pad positions: [B, width] float32."""
    t = tokens.shape[1]
    x = (enc["tok_emb"][tokens] + enc["pos_emb"][:t][None]).float()
    pad = tokens == PAD_ID
    mask = torch.zeros(pad.shape, dtype=torch.float32, device=x.device
                       ).masked_fill_(pad, -1e30)[:, None, None, :]
    for bp in enc["blocks"]:
        x = _block(bp, cfg, x, mask=mask)[0]
    x = _ln(x, enc["ln_f_scale"], enc["ln_f_bias"])
    keep = (~pad).float()[..., None]
    return (x * keep).sum(1) / keep.sum(1).clamp(min=1.0)


def _embed_inputs(params, cfg: CaptionerConfig, vision_emb, tokens):
    """vision_emb [B, nv, vision_dim], tokens [B, T] -> x [B, nv+T, d]."""
    prefix = (vision_emb.float() @ params["vis_proj_w"].float()
              + params["vis_proj_b"])
    tok = params["tok_emb"][tokens].float()
    x = torch.cat([prefix, tok], dim=1)
    return x + params["pos_emb"][:x.shape[1]][None].float()


def forward(params: Dict, cfg: CaptionerConfig, vision_emb: torch.Tensor,
            tokens: torch.Tensor, remat: bool = False,
            flash: bool = False) -> torch.Tensor:
    """Full-sequence forward: logits [B, T, vocab] (float32) for the token
    positions, differentiable w.r.t. every float leaf of ``params``.
    ``remat=True`` recomputes each block in the backward pass instead of
    keeping its activations (``jax.checkpoint`` in the JAX package): what
    training at a long sequence needs when the attention probabilities
    are materialised.  ``flash=True`` takes the CUDA kernels on the card,
    forward and backward, which keep one float32 per row instead."""
    with profiling.span("captioner.forward"):
        x = _embed_inputs(params, cfg, vision_emb, tokens)
        for bp in params["blocks"]:
            if remat and torch.is_grad_enabled():
                x = checkpoint(
                    lambda bp_, x_: _block(bp_, cfg, x_, flash)[0],
                    bp, x, use_reentrant=False)
            else:
                x = _block(bp, cfg, x, flash)[0]
        return _head_logits(params, cfg, x[:, cfg.num_vision_tokens:])


# ---------------------------------------------------------------------------
# KV-cache greedy decoding
# ---------------------------------------------------------------------------

def _step_block(bp, cfg: CaptionerConfig, x, kcache, vcache,
                write_slot: int, masked):
    """Single-token step.  x [B, 1, d]; caches [B, h, maxT, hd] float32,
    updated in place.  Every row's step-i K/V lands in cache slot
    ``write_slot = decode_base + i`` whatever its prompt length.
    ``masked`` [B, 1, 1, maxT] bool is True at the keys a row must not
    see: all but its prompt (``key < prompt_end``) and the decode slots
    ``[decode_base, write_slot]`` (``_decode_loop`` keeps it).  The
    attention, the qkv bias add and the cache writes included, is
    ``ops/decode_attention.py``: one kernel on the card."""
    b, _, d = x.shape
    hd = d // cfg.heads
    y = _ln(x, bp["ln1_scale"], bp["ln1_bias"]).to(cfg.dtype)
    y = _column_input(y, bp["qkv_w"], 3 * d)
    # ``_qkv``'s views of the product without its bias: the op adds it
    q, k, v = (z.reshape(b, 1, -1, hd) for z in
               wdot(y, bp["qkv_w"], cfg.dtype, cfg.qmode).chunk(3, dim=-1))
    o = decode_attention(q, k, v, bp["qkv_b"], kcache, vcache, write_slot,
                         masked, cfg.dtype)           # [B, 1, h * hd]
    x = x + _row_linear(o, bp["attn_o_w"], bp["attn_o_b"], cfg, d).float()
    return _mlp(bp, cfg, x)


def _prefill(params, cfg: CaptionerConfig, x, max_t: int,
             flash: bool = False) -> Tuple[torch.Tensor, List]:
    """Every block over the prompt ``x`` [B, t0, d], writing its K/V into
    fresh ``max_t``-slot caches.  Returns (x, caches)."""
    b, t0, d = x.shape
    caches = []
    for bp in params["blocks"]:
        x, k, v = _block(bp, cfg, x, flash)
        kc = torch.zeros((b, k.shape[2], max_t, k.shape[3]),
                         dtype=torch.float32, device=x.device)
        vc = torch.zeros_like(kc)
        kc[:, :, :t0] = k.transpose(1, 2)
        vc[:, :, :t0] = v.transpose(1, 2)
        caches.append((kc, vc))
    return x, caches


def _head_logits(params, cfg: CaptionerConfig, x):
    xf = _ln(x, params["ln_f_scale"], params["ln_f_bias"])
    return wdot(xf.to(cfg.dtype), params["head_w"], cfg.dtype,
                cfg.qmode).float()


def _decode_loop(params, cfg: CaptionerConfig, first_tok, caches,
                 start, max_new: int, decode_base: int,
                 grammar_trans=None, gstate=None) -> torch.Tensor:
    """Greedy KV-cached decode of up to ``max_new`` steps.  ``start`` [B]
    are the rows' decode positions (ragged prompts), ``decode_base`` the
    cache slot of step 0.  ``grammar_trans`` [S, vocab] int32 and
    ``gstate`` [B] mask each step's logits to the rows' DFA states (a
    zero entry is DEAD, disallowed) and advance them with the chosen
    token.  Returns [B, max_new] int32, EOS after a row's EOS."""
    b = first_tok.shape[0]
    dev = first_tok.device
    toks = torch.full((b, max_new), EOS_ID, dtype=torch.int32, device=dev)
    tok = first_tok
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    key = torch.arange(caches[0][0].shape[2], device=dev)
    masked = (key[None, :] >= start[:, None])[:, None, None, :]
    # every rank of the "model" group leaves at the same step
    mesh = active_mesh()
    group = None if mesh is None else axis_group(mesh, MODEL_AXIS)
    steps = checks = 0
    kernel_calls = attn_thread_launches()
    with profiling.span("captioner.decode") as decode:
        for i in range(max_new):
            # a step's span: its enqueue, and the all-done check (the
            # loop's one wait on the card) in a span of its own
            with profiling.span("captioner.decode_step"):
                toks[:, i] = tok
                done = done | (tok == EOS_ID)
                if i == max_new - 1:
                    break
                if i % _DONE_CHECK == _DONE_CHECK - 1:
                    checks += 1
                    with profiling.span("captioner.done_check"):
                        stop = comm.same_on_all(bool(done.all()), group)
                    if stop:
                        break
                # positions past max_len reuse the last embedding, as
                # JAX's clamped gather does (generate does not check the
                # budget)
                pos = torch.clamp(start + i, max=cfg.max_len - 1)
                x = (params["tok_emb"][tok]
                     + params["pos_emb"][pos])[:, None].float()
                masked[..., decode_base + i] = False
                for bp, (kc, vc) in zip(params["blocks"], caches):
                    x = _step_block(bp, cfg, x, kc, vc, decode_base + i,
                                    masked)
                logits = _head_logits(params, cfg, x)[:, 0]  # [B, vocab]
                if grammar_trans is not None:
                    allowed = grammar_trans[gstate] != 0
                    logits = logits.masked_fill(~allowed, -1e30)
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
                nxt = torch.where(done, torch.full_like(nxt, EOS_ID), nxt)
                if grammar_trans is not None:
                    gstate = grammar_trans[gstate, nxt]
                tok = nxt
                steps += 1
        decode.set("steps", steps)
        decode.set("done_checks", checks)
        decode.set("attn_kernel_calls",
                   attn_thread_launches() - kernel_calls)
    return toks


def decode_steps(tokens: torch.Tensor, max_new: int) -> int:
    """Decode steps ``_decode_loop`` ran for its output ``tokens``
    [B, max_new]: it stops at the first check after every row emitted EOS
    (every ``_DONE_CHECK`` steps), or after ``max_new - 1`` steps."""
    done = (tokens == EOS_ID).all(0).nonzero()
    first = int(done[0]) if len(done) else max_new
    check = first + (_DONE_CHECK - 1 - first) % _DONE_CHECK
    return max(1, min(max_new - 1, check))


def prefill_logits(params: Dict, cfg: CaptionerConfig, tokens: torch.Tensor,
                   max_new: int, flash: bool = False):
    """The prefill of ``generate_from_tokens``: (logits [B, nv+T_pad,
    vocab] float32, caches) for ``tokens`` [B, T_pad] with zeroed vision
    slots, the caches sized for ``max_new`` decode steps."""
    b, t_pad = tokens.shape
    nv = cfg.num_vision_tokens
    max_t = nv + t_pad + max_new
    if max_t > cfg.max_len:
        raise ValueError(f"prompt pad {t_pad} + max_new {max_new} exceeds "
                         f"max_len {cfg.max_len}")
    vis = torch.zeros((b, nv, cfg.vision_dim), dtype=torch.float32,
                      device=tokens.device)
    x = _embed_inputs(params, cfg, vis, tokens.long())
    x, caches = _prefill(params, cfg, x, max_t, flash=flash)
    return _head_logits(params, cfg, x), caches


@torch.no_grad()
def generate_from_tokens(params: Dict, cfg: CaptionerConfig,
                         tokens: torch.Tensor, prompt_len,
                         max_new: int = 256, grammar_trans=None,
                         grammar_start=None,
                         flash: bool = False) -> torch.Tensor:
    """Text-conditional greedy decode with real prompt tokens in the
    decoder context (the vision slots are zeroed).

    ``tokens`` [B, T_pad] right-padded with PAD_ID; ``prompt_len`` an int
    or an int32 [B] (ragged batch).  Each row generates from position
    ``nv + prompt_len[i]`` while its step-i K/V lands in the shared cache
    slot ``nv + T_pad + i``.  ``prompt_len == 0`` marks an inert filler
    row: it emits EOS from step 0.  ``grammar_trans`` [S, vocab] int32
    and ``grammar_start`` [B] int32 (``models/grammar.py``) constrain
    every emitted byte, the first included.  Returns [B, max_new] int32,
    EOS-padded."""
    b, t_pad = tokens.shape
    nv = cfg.num_vision_tokens
    dev = tokens.device
    with profiling.span("captioner.generate") as gen:
        gen.set("batch", b)
        with profiling.span("captioner.prefill"):
            prompt_len = torch.as_tensor(prompt_len, dtype=torch.int32,
                                         device=dev).expand(b)
            logits, caches = prefill_logits(params, cfg, tokens, max_new,
                                            flash)
            last = torch.clamp(nv + prompt_len.long() - 1, min=0)
            first_logits = logits[torch.arange(b, device=dev), last]
            gstate = None
            if grammar_trans is not None:
                grammar_start = torch.as_tensor(grammar_start,
                                                dtype=torch.long, device=dev)
                allowed0 = grammar_trans[grammar_start] != 0
                first_logits = first_logits.masked_fill(~allowed0, -1e30)
            first_tok = torch.argmax(first_logits, dim=-1).to(torch.int32)
            first_tok = torch.where(prompt_len > 0, first_tok,
                                    torch.full_like(first_tok, EOS_ID))
            if grammar_trans is not None:
                gstate = grammar_trans[grammar_start, first_tok.long()]
        return _decode_loop(params, cfg, first_tok, caches,
                            nv + prompt_len.long(), max_new,
                            decode_base=nv + t_pad,
                            grammar_trans=grammar_trans, gstate=gstate)


def vision_prefill(params: Dict, cfg: CaptionerConfig,
                   vision_emb: torch.Tensor, max_new: int,
                   flash: bool = True):
    """The prefill of ``generate``: the nv vision slots of ``vision_emb``
    [B, nv, vision_dim] and BOS, with the prefix-bidirectional causal
    mask.  Returns (the logits after BOS [B, vocab] float32, the caches
    sized for ``max_new`` decode steps)."""
    b = vision_emb.shape[0]
    max_t = cfg.num_vision_tokens + 1 + max_new
    bos = torch.full((b, 1), BOS_ID, dtype=torch.long,
                     device=vision_emb.device)
    x = _embed_inputs(params, cfg, vision_emb, bos)      # [B, nv+1, d]
    x, caches = _prefill(params, cfg, x, max_t, flash=flash)
    return _head_logits(params, cfg, x[:, -1:])[:, 0], caches


@torch.no_grad()
def generate(params: Dict, cfg: CaptionerConfig, vision_emb: torch.Tensor,
             max_new: int = 256, flash: bool = True) -> torch.Tensor:
    """Greedy caption decode from a vision prefix [B, nv, vision_dim].
    Returns token ids [B, max_new] int32, EOS after a row's EOS (the
    JAX package's ``generate``).  ``flash=True`` takes the CUDA kernel
    for the prefill on the card."""
    b = vision_emb.shape[0]
    t0 = cfg.num_vision_tokens + 1
    with profiling.span("captioner.generate") as gen:
        gen.set("batch", b)
        with profiling.span("captioner.prefill"):
            logits, caches = vision_prefill(params, cfg, vision_emb, max_new,
                                            flash)
            first_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            start = torch.full((b,), t0, dtype=torch.long,
                               device=vision_emb.device)
        return _decode_loop(params, cfg, first_tok, caches, start, max_new,
                            decode_base=t0)
