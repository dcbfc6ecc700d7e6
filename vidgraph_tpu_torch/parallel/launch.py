"""Start a function on n ranks, one process each, and collect what it returns.

    results = run_ranks("pkg.module:function", world=4, args=(...))

Each rank is ``python -m vidgraph_tpu_torch.parallel.launch`` in a fresh
interpreter: it initialises the default process group (``init_group``:
gloo on the CPU, NCCL or gloo on the card as ``backend`` says) from a
rendezvous file, calls ``function(*args)``, pickles the result and
destroys the group.  Ranks import nothing of JAX: a rank that has
``jax`` in ``sys.modules`` when its function returns fails.

A collective that hangs fails after ``timeout_s`` (the group's timeout),
and the whole run after ``deadline_s``: every rank still alive is then
killed and the call raises.  The kernels of ``ops/`` are built by the
caller before it starts ranks that launch them, so that no two ranks build
them at once.
"""
from __future__ import annotations

import argparse
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, List, Optional, Sequence

ROOT = Path(__file__).resolve().parents[2]


def run_ranks(target: str, world: int, args: Sequence[Any] = (), *,
              backend: Optional[str] = None, device: str = "cpu",
              timeout_s: float = 60.0, deadline_s: float = 300.0,
              pythonpath: Sequence[str] = (), threads: int = 1) -> List[Any]:
    """``target`` ("module:function") on ``world`` ranks computing on
    ``device``; returns each rank's result in rank order.  A rank that
    fails makes the call raise with its output's tail."""
    with tempfile.TemporaryDirectory(prefix="vidgraph_ranks_") as tmp:
        tmp = Path(tmp)
        (tmp / "args.pkl").write_bytes(pickle.dumps(tuple(args)))
        child_env = dict(os.environ)
        child_env["VIDGRAPH_TORCH_DEVICE"] = device
        child_env["OMP_NUM_THREADS"] = str(threads)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT), *pythonpath]
            + ([child_env["PYTHONPATH"]] if child_env.get("PYTHONPATH")
               else []))
        procs = []
        for r in range(world):
            cmd = [sys.executable, "-m", "vidgraph_tpu_torch.parallel.launch",
                   "--target", target, "--rank", str(r), "--world",
                   str(world), "--dir", str(tmp), "--timeout", str(timeout_s)]
            if backend:
                cmd += ["--backend", backend]
            log = open(tmp / f"rank{r}.log", "wb")
            # plain "cuda": each rank its own card (core/platform.py)
            rank_env = ({**child_env, "LOCAL_RANK": str(r)}
                        if device == "cuda" else child_env)
            procs.append((subprocess.Popen(cmd, env=rank_env, cwd=ROOT,
                                           stdout=log,
                                           stderr=subprocess.STDOUT), log))
        end = time.monotonic() + deadline_s
        try:
            for p, _ in procs:
                p.wait(timeout=max(0.1, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
        if failed:
            tails = "\n".join(
                f"--- rank {r} (rc {procs[r][0].returncode}):\n"
                + (tmp / f"rank{r}.log").read_text(errors="replace")[-3000:]
                for r in failed)
            raise RuntimeError(f"{target} on {world} ranks: ranks {failed} "
                               f"failed\n{tails}")
        return [pickle.loads((tmp / f"rank{r}.out").read_bytes())
                for r in range(world)]


def _main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--backend", default=None)
    a = ap.parse_args(argv)
    from .mesh import init_group, shutdown

    tmp = Path(a.dir)
    init_group(a.backend, rank=a.rank, world_size=a.world,
               init_method=f"file://{tmp / 'rendezvous'}",
               timeout_s=a.timeout)
    try:
        module, name = a.target.split(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(*pickle.loads((tmp / "args.pkl").read_bytes()))
        assert "jax" not in sys.modules, f"rank {a.rank} imported jax"
        (tmp / f"rank{a.rank}.out").write_bytes(pickle.dumps(result))
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
