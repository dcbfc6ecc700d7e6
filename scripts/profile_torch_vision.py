"""Where the time goes in the PyTorch port's vision stage (``backend.vlm:
tpu``), on one CUDA card.

    python3 scripts/profile_torch_vision.py [--port-root DIR] [--seed N]
        [--out DIR]

``ViTConfig.b32()`` and ``CaptionerConfig.base()`` at full width with
seed-initialised weights, served by ``TPUVLMClient`` as ``backend.vlm: tpu``
serves them (``preprocess: device``, ``fast_resize: true``, 256 new bytes)
with the fused ViT attention.  Frames are uint8 405 x 720 (what
``io/video.py`` makes of 16:9 video), a background of 30 and a coloured
square, made with numpy.  Prints three JSON lines:

1. ``kernels``: the preprocessing kernel at 5 and 160 frames -> 224 bf16
   and the short-attention kernel at 5 and 160 frames x 12 heads x N 50 x
   hd 64 bf16: the device's time per launch (``device_ms``, 50 launches
   replayed from a CUDA graph) and the time of a call of the wrapper
   (``call_ms``, CUDA-event median of 50, the host's launch included),
   with their max |error| against the plain versions; the preprocessing's
   device time also on the frames and on uniform noise in turns;
2. ``stages``: one 5-frame chunk stage by stage, host clock around work
   that ends in a synchronise, median of 5: the upload of the frames, the
   preprocessing, the ViT (fused and einsum), the captioner's prefill and
   ``generate`` (prefill and decode), and the whole ``caption_batch_sync``;
3. ``profile``: ``torch.profiler`` over one ``caption_batch_sync``: the
   device's busy time, kernel launches and device time by op.  The
   profiler's tracing of every launch stretches the wall of that call, so
   the busy share is given over both walls: the profiled one
   (``device_busy_share_of_profiled_wall``) and the unprofiled median of
   line 2 (``device_busy_share``, the one to read).

``--port-root DIR`` imports ``vidgraph_tpu_torch`` from the checkout at
DIR (its kernels build under DIR), so that two versions can be compared
in one call; ``--kernels-only`` stops after the first line.  The
``key_averages`` table goes to ``DIR/profile_torch_vision.txt`` (``--out``,
default ``build/profiles``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def frames(n: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = np.full((n, 405, 720, 3), 30, np.uint8)
    for i in range(n):
        x = int(rng.integers(0, 720 - 202))
        out[i, 101:303, x:x + 202] = rng.integers(0, 256, 3)
    return out


def host_ms(fn, reps: int = 5) -> float:
    """Median host milliseconds of ``fn()`` followed by a synchronise."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port-root", default=str(ROOT))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "profiles"))
    ap.add_argument("--kernels-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.port_root).resolve()))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_vision: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from vidgraph_tpu_torch.core.profiling import (cuda_ms, device_busy_us,
                                                   graph_ms)
    from vidgraph_tpu_torch.models.captioner import generate, vision_prefill
    from vidgraph_tpu_torch.models.vit import ViTConfig, VisionTower
    from vidgraph_tpu_torch.ops import preprocess as pre
    from vidgraph_tpu_torch.ops import short_attention as sa
    from vidgraph_tpu_torch.services.vlm_client import TPUVLMClient

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    root = str(Path(args.port_root).resolve())
    print(json.dumps({"card": card, "port_root": root}), flush=True)

    kernels = {}
    host = frames(160, args.seed)
    for n in (5, 160):
        x = torch.from_numpy(host[:n]).cuda()
        got = pre.preprocess_frames(x, 224, fast=True)
        err = float((got.float() - pre.preprocess_ref(x, 224, True).float())
                    .abs().max())
        noise = torch.from_numpy(np.random.default_rng(args.seed).integers(
            0, 256, host[:n].shape, dtype=np.uint8)).cuda()

        def launch(frames=x):
            return pre.preprocess_frames(frames, 224, fast=True)
        # the synthetic frames and uniform noise in turns: the kernel's
        # work does not depend on the pixels, its time should not either
        turns = [graph_ms(lambda: launch(f), reps=50)
                 for f in (x, noise, noise, x)]
        kernels[f"preprocess_{n}"] = {
            "device_ms": graph_ms(launch, reps=50),
            "device_ms_frames_noise_noise_frames": turns,
            "call_ms": cuda_ms(launch, reps=50), "max_abs_err": err}
        q, k, v = (torch.randn(n, 12, 50, 64, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        got = sa.fused_short_attention(q, k, v)
        err = float((got.float() - sa.short_attention_ref(q, k, v).float())
                    .abs().max())
        def attend():
            return sa.fused_short_attention(q, k, v)
        kernels[f"short_attention_{n}"] = {
            "device_ms": graph_ms(attend, reps=50),
            "call_ms": cuda_ms(attend, reps=50), "max_abs_err": err}
    print(json.dumps({"card": card, "kernels": kernels}), flush=True)
    if args.kernels_only:
        return 0

    client = TPUVLMClient(vit_cfg=ViTConfig(attn_impl="fused"),
                          seed=args.seed, preprocess="device",
                          fast_resize=True)
    einsum = VisionTower(ViTConfig()).cuda().eval()
    einsum.load_state_dict(client.vit.state_dict())
    chunk = list(host[:5])
    stack = host[:5]
    with torch.no_grad():
        xin = torch.from_numpy(stack).cuda()
        xp = pre.preprocess_frames(xin, 224, fast=True)
        vis = client.vision_prefixes([chunk], client.vit(xp))
        params, cfg = client._serve_params, client.cap_cfg
        stages = {
            "upload_ms": host_ms(lambda: torch.from_numpy(stack).cuda()),
            "preprocess_ms": host_ms(
                lambda: pre.preprocess_frames(xin, 224, fast=True)),
            "vit_fused_ms": host_ms(lambda: client.vit(xp)),
            "vit_einsum_ms": host_ms(lambda: einsum(xp)),
            "prefill_ms": host_ms(lambda: vision_prefill(
                params, cfg, vis, client.max_new)),
            "generate_ms": host_ms(lambda: generate(params, cfg, vis,
                                                    client.max_new)),
            "caption_ms": host_ms(lambda: client.caption_batch_sync(
                [chunk])),
        }
    print(json.dumps({"card": card, "stages": stages}), flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        client.caption_batch_sync([chunk])
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
        "card": card, "profile": {
            "wall_ms": wall_ms, "unprofiled_wall_ms": stages["caption_ms"],
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / stages["caption_ms"],
            "device_busy_share_of_profiled_wall": busy_ms / wall_ms,
            "launches": launches,
            "device_us_by_op": {
                name[:60]: {"calls": n, "us": us} for name, (n, us) in sorted(
                    by_op.items(), key=lambda kv: -kv[1][1])[:10]}}}),
        flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_torch_vision.txt").write_text(
        f"{card}\n{root}\n\n" + prof.key_averages().table(
            sort_by="self_cpu_time_total", row_limit=30))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
