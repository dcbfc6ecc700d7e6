"""Wall time of the captioner's greedy decode in two checkouts of the port,
in one process on one card, in turns.

    python scripts/compare_torch_decode.py --other <checkout> \
        [--config large] [--turns 10] [--max-new 256] [--seed 0]

Runs this checkout's ``models/captioner.py::generate`` and the other
checkout's (its ``vidgraph_tpu_torch`` loaded under another package name,
with its own kernels) on the same weights and vision prefix at B 1, in
turns (this, other, other, this, ...), each call timed on the host clock
up to a synchronise after it.  The B 1 decode is paced by the host, whose
speed drifts between processes by more than a small change moves it; in
turns inside one process the drift reaches both sides alike.  Prints one
JSON line: each side's call seconds and median, and whether the tokens
are equal.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def other_captioner(checkout: str):
    """``models.captioner`` of the port in ``checkout``, as the package
    ``vidgraph_other`` (the port's imports of itself are relative)."""
    pkg = Path(checkout).resolve() / "vidgraph_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "vidgraph_other", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["vidgraph_other"] = module
    spec.loader.exec_module(module)
    return importlib.import_module("vidgraph_other.models.captioner")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--config", default="large")
    ap.add_argument("--turns", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("compare_torch_decode: no CUDA card", file=sys.stderr)
        return 1
    from vidgraph_tpu_torch.models import captioner as this

    other = other_captioner(args.other)
    cfg = getattr(this.CaptionerConfig, args.config)()
    device = torch.device("cuda:0")
    params = this.init_params(cfg, args.seed, param_dtype=torch.bfloat16,
                              device=device)
    serve = this.serving_params(params, cfg)
    del params
    vis = torch.randn((1, cfg.num_vision_tokens, cfg.vision_dim),
                      generator=torch.Generator().manual_seed(args.seed)
                      ).to(device)
    sides = {"this": this, "other": other}
    seconds = {"this": [], "other": []}
    tokens = {}

    def call(side):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = sides[side].generate(serve, cfg, vis, max_new=args.max_new)
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    for side in sides:                  # builds, warms
        tokens[side] = call(side)[1].cpu()
    for _ in range(args.turns):
        for side in ("this", "other", "other", "this"):
            seconds[side].append(call(side)[0])
    print(json.dumps({
        "device": torch.cuda.get_device_name(device),
        "config": args.config, "max_new": args.max_new,
        "tokens_equal": bool(torch.equal(tokens["this"], tokens["other"])),
        "median_s": {k: statistics.median(v) for k, v in seconds.items()},
        "seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
