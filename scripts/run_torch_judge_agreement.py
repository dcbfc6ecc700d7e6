#!/usr/bin/env python3
"""Strict vs LLM-judged benchmark comparison with the PyTorch port.

Counterpart of ``scripts/run_judge_agreement.py``: the reference's
protocol is an LLM judge returning ``{"is_correct": bool}``; the strict
deterministic token-boundary judge is the repo's default.  Runs the same
retrieval-results file through the port's ``BenchmarkEvaluator`` twice,
once with the strict local judge and once with the on-device chat LM
(``benchmark_llm.judge_backend: tpu``: ``TPUChatClient`` under
grammar-constrained decode, on ``VIDGRAPH_TORCH_DEVICE``, ``cuda`` by
default), and writes both accuracies and the per-question agreement to
``OUTDIR/judge_agreement.json`` with the JAX script's keys.

  python3 scripts/run_torch_judge_agreement.py \\
      --input retrieval_results.json \\
      [--config config/judge_tpu_config.yaml] [--outdir outputs]

The config's ``llm_injector.checkpoint_path`` names the chat LM's npz (the
JAX package's format).
"""
from __future__ import annotations

import argparse
import asyncio
import copy
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from vidgraph_tpu_torch.core.config import PipelineConfig  # noqa: E402
from vidgraph_tpu_torch.pipeline.benchmark import \
    BenchmarkEvaluator  # noqa: E402


def _run(config, input_path: str, out_path: str) -> dict:
    ev = BenchmarkEvaluator(config)
    return asyncio.run(ev.evaluate_retrieval_results(input_path, out_path))


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True,
                    help="batch-retrieve output (retrieval results JSON)")
    ap.add_argument("--config", default="config/judge_tpu_config.yaml")
    ap.add_argument("--outdir", default="outputs")
    args = ap.parse_args(argv)

    cfg_llm = PipelineConfig.from_yaml(args.config)
    assert cfg_llm.benchmark_llm.judge_backend == "tpu", (
        "config must pin benchmark_llm.judge_backend: tpu")
    cfg_strict = copy.deepcopy(cfg_llm)
    cfg_strict.benchmark_llm.judge_backend = "local"

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    strict = _run(cfg_strict, args.input, str(outdir / "bench_strict.json"))
    llm = _run(cfg_llm, args.input, str(outdir / "bench_llm_judge.json"))

    s_res = {r["query"]: r["is_correct"] for r in strict["results"]}
    l_res = {r["query"]: r["is_correct"] for r in llm["results"]}
    keys = sorted(s_res)
    agree = sum(1 for q in keys if s_res[q] == l_res[q])
    flips = [{"query": q, "strict": s_res[q], "llm": l_res[q],
              "answer": next(r["retrieved_answer"]
                             for r in strict["results"]
                             if r["query"] == q),
              "groundtruth": next(r["groundtruth"]
                                  for r in strict["results"]
                                  if r["query"] == q)}
             for q in keys if s_res[q] != l_res[q]]

    summary = {
        "n": len(keys),
        "strict_accuracy": strict["statistics"]["accuracy"],
        "llm_judge_accuracy": llm["statistics"]["accuracy"],
        "agreement": round(agree / max(len(keys), 1), 4),
        "flips": flips,
    }
    (outdir / "judge_agreement.json").write_text(
        json.dumps(summary, indent=2))
    print(json.dumps({k: v for k, v in summary.items() if k != "flips"},
                     indent=2))
    for f in flips:
        print(f"FLIP strict={f['strict']} llm={f['llm']}: "
              f"{f['query'][:60]!r} ans={f['answer'][:60]!r} "
              f"gt={f['groundtruth'][:40]!r}")
    return summary


if __name__ == "__main__":
    main()
