"""Where the time goes in the PyTorch port's chat-LM dispatch, on one CUDA
card (counterpart of ``scripts/profile_chat_decode.py``).

    python3 scripts/profile_torch_chat_decode.py [--shapes B,T,N;...]
        [--no-flash] [--out DIR]

``CaptionerConfig.chat()`` at full width with seed-initialised weights,
served as ``TPUChatClient`` serves them (``serving_params``, the pipeline
grammar with the pre-extraction contract on every row).  For each
(b_pad, t_pad, max_new) it prints one JSON line: the prefill's time and
the whole dispatch's (``generate_from_tokens``, host clock around work
that ends in a synchronise), ms per decode step, and, over a profiled
32-step dispatch, the device's busy share, kernel launches per step and
the device time by op.  ``--no-flash`` takes the plain attention in the
prefill.  The ``key_averages`` tables go to
``DIR/profile_torch_chat_decode.txt`` (default ``build/profiles``).
"""
from __future__ import annotations

import argparse
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

PROFILED_STEPS = 32


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="1,2048,128;8,2048,128;32,2048,128")
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "build" / "profiles"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_chat_decode: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from vidgraph_tpu_torch.models import tokenizer
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     decode_steps,
                                                     generate_from_tokens,
                                                     init_params,
                                                     prefill_logits,
                                                     serving_params)
    from vidgraph_tpu_torch.models.grammar import pipeline_grammar

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    cfg = CaptionerConfig.chat()
    params = serving_params(init_params(cfg, device=dev), cfg)
    grammar = pipeline_grammar()
    flash = not args.no_flash
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    tables = []
    for shape in args.shapes.split(";"):
        b, t_pad, max_new = map(int, shape.split(","))
        toks = np.full((b, t_pad), tokenizer.PAD_ID, np.int32)
        lens = np.zeros((b,), np.int32)
        for r in range(b):       # ragged prompts of 200 bytes to t_pad - 1
            text = "TRIPLET LINES: the scene shows a red object. " * (
                4 + r * t_pad // (46 * max(b, 1)))
            ids = tokenizer.encode(text, add_bos=True,
                                   add_eos=False)[:t_pad - 1]
            toks[r, :len(ids)] = ids
            lens[r] = len(ids)
        toks = torch.from_numpy(toks).to(dev)
        lens = torch.from_numpy(lens).to(dev)
        kw = {"grammar_trans": grammar.device_table(),
              "grammar_start": torch.full((b,), grammar.starts["pre"],
                                          dtype=torch.int32, device=dev),
              "flash": flash}

        def dispatch(n):
            return generate_from_tokens(params, cfg, toks, lens,
                                        max_new=n, **kw)

        dispatch(16)                                     # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.no_grad():
            prefill_logits(params, cfg, toks, max_new, flash=flash)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        t = time.perf_counter()
        out = dispatch(max_new)
        torch.cuda.synchronize()
        dispatch_s = time.perf_counter() - t
        steps = decode_steps(out, max_new)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            dispatch(PROFILED_STEPS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
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
        print(json.dumps({
            "card": card, "b_pad": b, "t_pad": t_pad, "max_new": max_new,
            "flash": flash, "prefill_ms": prefill_s * 1e3,
            "dispatch_s": dispatch_s, "decode_steps": steps,
            "ms_per_step": (dispatch_s - prefill_s) * 1e3 / steps,
            "profiled_steps": PROFILED_STEPS, "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "launches_per_step": launches / PROFILED_STEPS,
            "device_us_by_op": {
                name[:60]: {"calls": n, "us": us} for name, (n, us) in sorted(
                    by_op.items(), key=lambda kv: -kv[1][1])[:10]}}),
            flush=True)
        tables.append(f"b_pad {b}, t_pad {t_pad}, {PROFILED_STEPS} steps\n"
                      + prof.key_averages().table(
                          sort_by="self_cpu_time_total", row_limit=30))
    (out / "profile_torch_chat_decode.txt").write_text(
        f"{card}\n\n" + "\n\n".join(tables))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
