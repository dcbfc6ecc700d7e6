"""Where the time goes in one training step of the PyTorch port, on one
CUDA card.

    python3 scripts/profile_torch_train_step.py [--which instruct,midscale]
        [--no-flash] [--out DIR]

Two steps of the trainers, at full width from seed weights on random byte
tokens (a step's cost does not depend on the data):

* ``instruct``: ``scripts/train_torch_instruct_lm.py`` at
  ``CaptionerConfig.chat()`` width, batch 8 x seq 3072 (its long bucket)
  and 16 x 1536 (its short one);
* ``midscale``: ``scripts/train_torch_midscale.py`` at the 204M
  ``mid_config``, batch 16 x seq 1024.

Each step is the trainer's own: its loss function, backward, the global-
norm clip and the scheduled AdamW update (``models/train.py::AdamW``),
with ``--flash`` semantics (the CUDA FlashAttention kernels, remat off)
unless ``--no-flash`` (the masked einsum with remat on).  For each it
prints one JSON line: the unprofiled step time (host clock around 5 steps
that end in a synchronise), tokens/s, MFU against the H100's 989 TFLOP/s
dense bf16 peak, peak device memory, and, over one profiled step, the
device's busy share (the union of the device events over the UNPROFILED
step time: the profiler stretches the host side), kernel launches a step,
the flash kernels' launches and the device time by kernel.  The
``key_averages`` tables go to ``DIR/profile_torch_train_step.txt`` (default
``build/profiles``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from vidgraph_tpu_torch.core.profiling import device_busy_us  # noqa: E402

TIMED_STEPS = 5


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profile_step(name: str, cfg, loss_of, batch_shape, flash: bool,
                 flops_per_token: float, card: str) -> tuple:
    """(the JSON record, the ``key_averages`` table) of one training step
    of ``loss_of(params, tokens)`` at ``batch_shape`` = (B, L)."""
    from vidgraph_tpu_torch.models.captioner import init_params
    from vidgraph_tpu_torch.models.train import (
        AdamW, warmup_cosine_decay_schedule)
    from vidgraph_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    params = init_params(cfg, 0, device=dev,
                         requires_grad=True)
    opt = AdamW(params, warmup_cosine_decay_schedule(0.0, 3e-4, 2, 1000,
                                                     3e-5),
                weight_decay=0.01, max_norm=1.0)
    b, length = batch_shape
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (b, length + 1)).astype(np.int32)).to(dev)

    def step():
        opt.zero_grad()
        loss = loss_of(params, toks)
        loss.backward()
        opt.update()
        return loss

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(TIMED_STEPS):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / TIMED_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    fa.reset_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t) * 1e3
    events = prof.events()
    devev = [e for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(1 for e in events if e.name in (
        "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    by_op = defaultdict(lambda: [0, 0.0])
    for e in devev:
        by_op[e.name][0] += 1
        by_op[e.name][1] += e.time_range.end - e.time_range.start
    busy_ms = device_busy_us(devev) / 1e3
    tokens = b * length
    tok_s = tokens / (step_ms / 1e3)
    record = {
        "card": card, "step": name, "batch": b, "seq_len": length,
        "layers": cfg.layers, "width": cfg.width,
        "attention": "flash" if flash else "einsum", "remat": not flash,
        "loss": loss.item(), "step_ms": step_ms, "tokens_per_sec": tok_s,
        "train_mfu": flops_per_token * tok_s / 989e12,
        "mfu_peak": "H100 SXM dense bf16, 989 TFLOP/s",
        "peak_memory_gb": peak_gb, "profiled_step_ms": profiled_ms,
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / step_ms,
        "launches_per_step": launches, "device_events": len(devev),
        "flash_launches": dict(fa.LAUNCHES), "plain_calls": fa.REF_CALLS,
        "device_us_by_op": {
            op[:70]: {"calls": n, "us": us} for op, (n, us) in sorted(
                by_op.items(), key=lambda kv: -kv[1][1])[:12]}}
    table = (f"{name}: {b} x {length}, {record['attention']}\n"
             + prof.key_averages().table(sort_by="self_cuda_time_total",
                                         row_limit=30))
    del params, opt
    torch.cuda.empty_cache()
    return record, table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--which", default="instruct,midscale")
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "build" / "profiles"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train_step: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from vidgraph_tpu_torch.models.captioner import CaptionerConfig

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    flash = not args.no_flash
    instruct = _script("train_torch_instruct_lm")
    midscale = _script("train_torch_midscale")
    jobs = []
    which = args.which.split(",")
    if "instruct" in which:
        cfg = CaptionerConfig.chat()
        for b, length in ((8, 3072), (16, 1536)):
            # every prompt a quarter of the row: the loss spans the rest
            plens = torch.full((b,), length // 4, dtype=torch.int32,
                               device="cuda")
            jobs.append((f"instruct {b}x{length}", cfg,
                         lambda p, t, c=cfg, pl=plens: instruct.instruct_loss(
                             p, c, t, pl, not flash, flash), (b, length)))
    if "midscale" in which:
        cfg = midscale.mid_config(1024)
        jobs.append(("midscale 16x1024", cfg,
                     lambda p, t, c=cfg: midscale.lm_loss(p, c, t, not flash,
                                                          flash), (16, 1024)))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tables = []
    for name, cfg, loss_of, shape in jobs:
        record, table = profile_step(
            name, cfg, loss_of, shape, flash,
            midscale.train_flops_per_token(cfg, shape[1]), card)
        print(json.dumps(record), flush=True)
        tables.append(table)
    (out / "profile_torch_train_step.txt").write_text(
        f"{card}\n\n" + "\n\n".join(tables))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
