"""Weight-only int8 decode of the PyTorch port on one CUDA card
(counterpart of ``scripts/profile_int8_decode.py``).

    python3 scripts/profile_torch_int8_decode.py [--scale large|base]
        [--batches 8 32] [--max-new 64] [--reps 3] [--no-profile]
        [--out DIR]

Seed weights for ``CaptionerConfig.large()`` (1.2B) or ``base()`` drawn in
bfloat16, served four ways through ``models/captioner.py::generate``:

  bf16       the float tree
  int8_a16   ``(x @ q.to(bf16)) * s``: a bf16 [K, N] matrix written a call
  int8_a8    per-row int8 activations, int8 x int8 with int32 sums
  int8_a16p  the hand-written kernel of ``ops/q8_matmul.py``

For each mode and batch: tokens/s, ms per decode step (host clock around
calls that end in a synchronise), the tree's bytes, the share of the
card's peak memory rate (3.35 TB/s, an H100 SXM) that reading the tree
once a step comes to and, unless ``--no-profile``, the device's busy share
(device time of one profiled ``generate`` over the unprofiled wall: the
profiler stretches the wall), the kernel launches a step, and the
``q8_matmul`` wrapper's launches a call with the device time of its
kernel (one launch a product).  Then teacher-forced ``forward`` logits of
each int8 mode against bf16 (cosine) and greedy token match; with random
weights the logits are near uniform, so tokens diverge on noise and the
cosine is the signal.  The last line is one JSON object.  The
``key_averages`` tables go to ``DIR/profile_torch_int8_decode.txt``
(default ``build/profiles``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_PEAK = 3.35e12  # bytes/s, NVIDIA H100 SXM (data sheet)
MODES = (("bf16", None), ("int8_a16", "a16"), ("int8_a8", "a8"),
         ("int8_a16p", "a16p"))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def serving_trees(cfg, params):
    """{mode name: (serving tree, config)} for the four modes, from the
    float tree ``params``."""
    from vidgraph_tpu_torch.models.captioner import serving_params
    from vidgraph_tpu_torch.models.quant8 import quantize_captioner_params

    qparams = serving_params(quantize_captioner_params(params), cfg)
    fparams = serving_params(params, cfg)
    return {name: ((fparams, cfg) if mode is None else
                   (qparams, dataclasses.replace(cfg, qmode=mode)))
            for name, mode in MODES}


def bench_decode(params, cfg, batches, max_new: int, reps: int,
                 profiled: bool = False) -> dict:
    """``generate`` at each batch size: tokens/s and ms/step over ``reps``
    calls after a warm-up, and the q8 kernel's launches a step; with
    ``profiled``, one more call under ``torch.profiler`` for the device's
    busy time and the launches a step."""
    from vidgraph_tpu_torch.core.profiling import device_busy_us
    from vidgraph_tpu_torch.models.captioner import decode_steps, generate
    from vidgraph_tpu_torch.models.quant8 import tree_bytes
    from vidgraph_tpu_torch.ops import q8_matmul as q8

    rng = np.random.default_rng(0)
    pbytes = tree_bytes(params)
    rows = {}
    for b in batches:
        vis = torch.from_numpy(rng.normal(
            size=(b, cfg.num_vision_tokens, cfg.vision_dim)
        ).astype(np.float32)).cuda()
        generate(params, cfg, vis, max_new=max_new)         # warm-up
        torch.cuda.synchronize()
        q8.reset_counts()
        t0 = time.perf_counter()
        for _ in range(reps):
            toks = generate(params, cfg, vis, max_new=max_new)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = decode_steps(toks, max_new)
        row = {
            "tokens_per_sec": b * max_new * reps / dt,
            "ms_per_step": dt / (reps * max_new) * 1e3,
            "decode_steps": steps,
            "peak_bandwidth_share": pbytes * (max_new * reps / dt)
            / HBM_PEAK,
            "q8_launches_per_call": q8.LAUNCHES["q8_matmul"] / reps,
            "q8_plain_calls": q8.REF_CALLS,
        }
        if profiled:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                toks = generate(params, cfg, vis, max_new=max_new)
                torch.cuda.synchronize()
                profiled_ms = (time.perf_counter() - t0) * 1e3
            events = prof.events()
            devev = [e for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            # cudaLaunchKernel, cudaLaunchKernelExC (a cluster launch),
            # cuLaunchKernel, cuLaunchKernelEx
            launches = sum(1 for e in events if e.name.startswith(
                ("cudaLaunchKernel", "cuLaunchKernel")))
            busy_ms = device_busy_us(devev) / 1e3
            q8_us = [e.time_range.end - e.time_range.start for e in devev
                     if "q8_matmul" in e.name]
            row.update({
                "device_busy_ms": busy_ms,
                "device_busy_share": busy_ms / (dt / reps * 1e3),
                "profiled_wall_ms": profiled_ms,
                "launches_per_step": launches / max_new,
                "q8_kernel_device_ms": sum(q8_us) / 1e3,
                "q8_kernel_events": len(q8_us),
                "profiled_decode_steps": decode_steps(toks, max_new)})
            row["_table"] = prof.key_averages().table(
                sort_by="cuda_time_total", row_limit=25)
        rows[b] = row
    return {"weight_bytes": pbytes, "batches": rows}


def sequence_logits(params, cfg, vis, toks, flash=True) -> torch.Tensor:
    """Teacher-forced ``forward`` logits, one sequence a call: nv + T rows
    (40 here), so that ``qmode='a16p'`` takes the kernel, which a product
    of more than 64 rows does not.  ``flash=False`` takes the plain
    attention in the place of the flash kernel."""
    from vidgraph_tpu_torch.models.captioner import forward

    with torch.no_grad():
        return torch.cat([forward(params, cfg, vis[i:i + 1], toks[i:i + 1],
                                  flash=flash) for i in range(len(toks))])


def numerics(trees, cfg, max_new: int = 32) -> dict:
    """Each int8 mode against bf16 on one seeded batch: the cosine of the
    teacher-forced logits and the share of equal greedy tokens."""
    from vidgraph_tpu_torch.models.captioner import generate

    rng = np.random.default_rng(1)
    vis = torch.from_numpy(rng.normal(
        size=(4, cfg.num_vision_tokens, cfg.vision_dim)).astype(
        np.float32)).cuda()
    toks = torch.from_numpy(rng.integers(3, 250, (4, 32))).cuda()

    def logits(name):
        return sequence_logits(*trees[name], vis, toks).flatten().double()

    ref_l = logits("bf16")
    ref_t = generate(*trees["bf16"], vis, max_new=max_new)
    out = {}
    for name in [n for n, mode in MODES if mode]:
        got_l = logits(name)
        out[f"logits_cosine_{name}"] = float(
            ref_l @ got_l / (ref_l.norm() * got_l.norm()))
        out[f"logits_max_abs_diff_{name}"] = float((ref_l - got_l).abs().max())
        got_t = generate(*trees[name], vis, max_new=max_new)
        out[f"token_match_{name}"] = float((ref_t == got_t).float().mean())
    out["logit_scale"] = float(ref_l.abs().max())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", default="large", choices=("base", "large"))
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "build" / "profiles"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_int8_decode: needs a CUDA card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     init_params)

    card = card_line()
    print(card, flush=True)
    cfg = getattr(CaptionerConfig, args.scale)()
    params = init_params(cfg, param_dtype=torch.bfloat16,
                         device=torch.device("cuda"))
    trees = serving_trees(cfg, params)
    report = {"card": card, "scale": args.scale, "params": cfg.num_params,
              "max_new": args.max_new, "reps": args.reps}
    tables = []
    for name, (p, c) in trees.items():
        res = bench_decode(p, c, args.batches, args.max_new, args.reps,
                           profiled=not args.no_profile)
        for b, row in res["batches"].items():
            if "_table" in row:
                tables.append(f"{name}, batch {b}\n" + row.pop("_table"))
        report[name] = res
        print(f"[{name}] {res['weight_bytes'] / 1e9:.2f} GB  " + "  ".join(
            f"b{b}: {r['tokens_per_sec']:.0f} tok/s "
            f"({r['ms_per_step']:.3f} ms/step, "
            f"{r['peak_bandwidth_share']:.4f} of 3.35 TB/s"
            + (f", device busy {r['device_busy_share']:.3f}, "
               f"{r['launches_per_step']:.0f} launches/step"
               if "device_busy_share" in r else "") + ")"
            for b, r in res["batches"].items()), flush=True)
    report.update(numerics(trees, cfg))
    if tables:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "profile_torch_int8_decode.txt").write_text(
            f"{card}\n\n" + "\n\n".join(tables))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
