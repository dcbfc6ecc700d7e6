"""Time the kernels of two trees of the PyTorch port in turns, on one
CUDA card.

    python3 scripts/compare_torch_kernels.py --parent DIR [--train]
        [--rounds 2] [--jobs cosine,flash_fwd,short_attention,flash_bwd]

``DIR`` holds another commit of this repository (for example
``git archive <commit> | tar -x -C DIR``, in a directory ``.gitignore``
lists).  Kernel times spread about 7 % between calls to a card, so two
versions are compared only within one process tree on one card: the
script runs the parent, this tree, this tree, the parent (``--rounds``
pairs), each in a fresh process that imports that tree's
``vidgraph_tpu_torch`` and builds its kernels into that tree's
``build/kernels``.  The shapes, checks and yardsticks are this tree's
``chip_smoke.py``'s; each process prints one JSON line with the jobs
named by ``--jobs`` (all four by default):

* ``cosine``: phase 2's top-5 of the 200,000 x 512 float32 store at B 1
  and 16 and its dense scores at B 16, each held to the plain version
  (``TOL``): CUDA-event medians of a call and device times from CUDA-graph
  replay (``graph_ms``), with the library calls (``torch.topk`` over masked
  ``F.normalize(q) @ S.T``, and that product alone) beside them;
* ``flash_fwd``: the forward at phase 6's serving shapes (B 1, 8, 32 x T
  2056 x 8 heads x 64, and 1 x 2056 x 16 x 128; SDPA beside) and with its
  log-sum-exp at phase 14's three training shapes, each held to
  ``attention_ref`` (and ``lse_ref``) first;
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


def load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def cosine_job(smoke) -> dict:
    """Phase 2's timed calls at 200,000 x 512, each checked first."""
    import numpy as np
    import torch

    from vidgraph_tpu_torch.core.profiling import cuda_ms, graph_ms
    from vidgraph_tpu_torch.ops import topk_cosine as tc

    rng = np.random.default_rng(0)
    host = rng.normal(size=(smoke.STORE_ROWS, smoke.DIM)).astype(np.float32)
    host /= np.linalg.norm(host, axis=1, keepdims=True)
    store = torch.from_numpy(host).cuda()
    queries = torch.from_numpy(
        rng.normal(size=(16, smoke.DIM)).astype(np.float32)).cuda()
    count = smoke.STORE_COUNT
    past = torch.arange(smoke.STORE_ROWS, device="cuda") >= count
    rows = {}
    for b in (1, 16):
        q = queries[:b]
        err = smoke.check_topk(tc, q, store, 5, count)
        rows[f"topk_b{b}_k5"] = {
            "max_abs_err": err,
            "kernel_ms": cuda_ms(lambda: tc.cosine_topk(q, store, 5,
                                                        count=count)),
            "device_ms": graph_ms(lambda: tc.cosine_topk(q, store, 5,
                                                         count=count)),
            "library_ms": cuda_ms(
                lambda: smoke.library_topk(q, store, past, 5))}
    dense = tc.cosine_scores(queries, store, count=count)
    torch.cuda.synchronize()
    err = float((dense - tc.cosine_scores_ref(queries, store, count=count))
                .abs().max())
    assert err <= smoke.TOL, f"dense score error {err}"
    rows["dense_b16"] = {
        "max_abs_err": err,
        "kernel_ms": cuda_ms(lambda: tc.cosine_scores(queries, store,
                                                      count=count)),
        "device_ms": graph_ms(lambda: tc.cosine_scores(queries, store,
                                                       count=count)),
        "library_ms": cuda_ms(
            lambda: smoke.library_scores(queries, store, past))}
    return rows


def flash_fwd_job(smoke) -> dict:
    """The forward at phase 6's T = 2056 shapes and phase 14's timed
    training shapes (with the log-sum-exp), each checked first."""
    import numpy as np
    import torch

    from vidgraph_tpu_torch.core.profiling import cuda_ms
    from vidgraph_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(2)
    shapes = [(b, t, h, hd, 8, False) for b, t, h, hd in smoke.FLASH_SHAPES
              if t == 2056]
    shapes += [(b, t, h, hd, nv, True)
               for b, t, h, hd, nv in smoke.BWD_SHAPES[:smoke.BWD_TIMED]]
    rows = {}
    for b, t, h, hd, nv, with_lse in shapes:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, t, h, hd), dtype=np.float32)).to("cuda", torch.bfloat16)
            for _ in range(3))
        out, lse = fa._cuda_flash(q, k, v, nv, with_lse=with_lse)
        torch.cuda.synchronize()
        err = excess = lse_err = 0.0
        for i in range(b):                  # the plain version row by row
            ref = fa.attention_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                   nv).to(torch.bfloat16).float()
            diff = (out[i:i + 1].float() - ref).abs()
            err = max(err, float(diff.max()))
            excess = max(excess, float(
                (diff - fa.TOL_ABS - fa.TOL_REL * ref.abs()).max()))
            if with_lse:
                lse_err = max(lse_err, float((lse[i] - fa.lse_ref(
                    q[i:i + 1], k[i:i + 1], nv)[0]).abs().max()))
        assert excess <= 0 and lse_err <= 2e-3, (b, t, h, hd, err, lse_err)
        row = {"max_abs_err": err, "kernel_ms": cuda_ms(
            lambda: fa._cuda_flash(q, k, v, nv, with_lse=with_lse))}
        if with_lse:
            row["lse_err"] = lse_err
        if not with_lse:
            row["library_ms"] = smoke.library_sdpa(
                q, k, v, fa.prefix_causal_mask(t, nv, q.device))["library_ms"]
        rows[f"b{b}_T{t}_h{h}x{hd}" + ("_lse" if with_lse else "")] = row
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    return rows


def flash_bwd_job(smoke) -> dict:
    """The backward at phase 14's timed training shapes, SDPA beside."""
    import numpy as np
    import torch

    from vidgraph_tpu_torch.core.profiling import cuda_ms
    from vidgraph_tpu_torch.ops import flash_attention as fa

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
    return bwd


JOBS = {"cosine": cosine_job, "flash_fwd": flash_fwd_job,
        "short_attention": lambda smoke: smoke.phase_short_attention(
            0, smoke.nvidia_smi()),
        "flash_bwd": flash_bwd_job}


def worker(root: Path, jobs) -> dict:
    sys.path.insert(0, str(root))
    import torch

    smoke = load_smoke()
    from vidgraph_tpu_torch.ops import _build
    from vidgraph_tpu_torch.ops import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    rec = {"tree": str(root), "build_s": time.perf_counter() - t0}
    for job in jobs:
        rec[job] = JOBS[job](smoke)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--jobs", default=",".join(JOBS))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    jobs = [j for j in args.jobs.split(",") if j]
    unknown = set(jobs) - set(JOBS)
    if unknown:
        ap.error(f"unknown jobs {sorted(unknown)}; known: {sorted(JOBS)}")
    if args.worker:
        print(json.dumps(worker(Path(args.worker), jobs)), flush=True)
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
             str(root), "--jobs", ",".join(jobs)], capture_output=True,
            text=True, cwd=root)
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
