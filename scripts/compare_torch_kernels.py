"""Time the short-attention and FlashAttention-backward kernels of two
trees of the PyTorch port in turns, on one CUDA card.

    python3 scripts/compare_torch_kernels.py --parent DIR [--train]
        [--rounds 2]

``DIR`` holds another commit of this repository (for example
``git archive <commit> | tar -x -C DIR``, in a directory ``.gitignore``
lists).  Kernel times spread about 7 % between calls to a card, so two
versions are compared only within one process tree on one card: the
script runs the parent, this tree, this tree, the parent (``--rounds``
pairs), each in a fresh process that imports that tree's
``vidgraph_tpu_torch`` and builds its kernels into that tree's
``build/kernels``.  The shapes, checks and yardsticks are this tree's
``chip_smoke.py``'s; each process prints one JSON line:

* ``short_attention``: ``chip_smoke.py::phase_short_attention`` (phase 10:
  B 1, 5, 160 x 12 heads x N 50 x hd 64 bf16 and the ViT's strided views,
  each held to the plain version, then device times of the kernel, the
  plain version and SDPA);
* ``flash_bwd``: ``_cuda_flash_bwd`` (every backward launch) at phase 14's
  timed training shapes (``BWD_SHAPES[:BWD_TIMED]``): CUDA-event medians,
  and ``library_sdpa_train`` (SDPA's backward under autograd) beside it.

``--train`` also runs each tree's ``scripts/profile_torch_train_step.py``
(instruct and mid-scale steps with ``--flash``) in the same order.  The
card's name and power limit head the output.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def worker(root: Path) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from vidgraph_tpu_torch.core.profiling import cuda_ms
    from vidgraph_tpu_torch.ops import _build
    from vidgraph_tpu_torch.ops import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    rec = {"tree": str(root), "build_s": time.perf_counter() - t0}
    card = smoke.nvidia_smi()
    rec["short_attention"] = smoke.phase_short_attention(0, card)

    rng = np.random.default_rng(0)
    bwd = {}
    for b, t, h, hd, nv in smoke.BWD_SHAPES[:smoke.BWD_TIMED]:
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            (b, t, h, hd), dtype=np.float32)).to("cuda", torch.bfloat16)
            for _ in range(4))
        out, lse = fa._cuda_flash(q, k, v, nv, with_lse=True)
        row = {"bwd_ms": cuda_ms(lambda: fa._cuda_flash_bwd(
            q, k, v, out, lse, do, nv))}
        row.update(smoke.library_sdpa_train(
            q, k, v, do, fa.prefix_causal_mask(t, nv, q.device)))
        bwd[f"b{b}_T{t}_h{h}x{hd}_nv{nv}"] = row
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    rec["flash_bwd"] = bwd
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(Path(args.worker))), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_torch_kernels: no CUDA card", file=sys.stderr)
        return 1
    if not args.parent:
        ap.error("--parent DIR is required")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    parent = Path(args.parent).resolve()
    order = []
    for _ in range(args.rounds):
        order += [("parent", parent), ("change", ROOT), ("change", ROOT),
                  ("parent", parent)]
    order = order[:2 * args.rounds]
    status = 0
    for label, root in order:
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker",
             str(root)], capture_output=True, text=True, cwd=root)
        status |= res.returncode
        line = res.stdout.strip().splitlines()[-1:] or [res.stderr[-2000:]]
        print(f"{label}: {line[0]}", flush=True)
    if args.train:
        for label, root in order:
            res = subprocess.run(
                [sys.executable, str(root / "scripts" /
                                     "profile_torch_train_step.py")],
                capture_output=True, text=True, cwd=root)
            status |= res.returncode
            for line in res.stdout.strip().splitlines():
                print(f"{label} train: {line}", flush=True)
            if res.returncode:
                print(res.stderr[-2000:], flush=True)
    return status


if __name__ == "__main__":
    raise SystemExit(main())
