"""The port's tooling scripts on the CPU, against the JAX package's.

* ``scripts/run_torch_parameter_sweep.py --dry-run`` writes the config
  YAMLs, epoch summaries and sweep summary of
  ``scripts/run_parameter_sweep.py`` for the same seed (paths aside),
  and its stages call the port's CLI.
* ``scripts/profile_torch_vit.py --smoke --device cpu`` prints its JSON
  record: every stage of ``scripts/profile_vit.py`` and the three
  attention rows, no device rate from a host run.
* ``scripts/run_torch_judge_agreement.py`` on a small retrieval-results
  file, with the chat LM from seed weights on the CPU: the JAX script's
  keys, and its strict half equal to the JAX package's strict benchmark
  of the same file.
"""
import asyncio
import copy
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("VIDGRAPH_TORCH_DEVICE", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402
import yaml  # noqa: E402

ROOT = Path(__file__).parent.parent


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sweep(script: str, out: Path, *extra: str) -> None:
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / script), "--vlm-output",
         "unused.json", "--queries", "unused.json", "--output-dir",
         str(out), "--dry-run", *extra],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("extra", [("--epochs", "4"),
                                   ("--epochs", "3", "--seed", "7"),
                                   ("--epochs", "2", "--base-config",
                                    str(ROOT / "config" /
                                        "tpu_llm_config.yaml"))])
def test_sweep_dry_run_equals_the_jax_script(tmp_path, extra):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    _sweep("run_parameter_sweep.py", jax_dir, *extra)
    _sweep("run_torch_parameter_sweep.py", port_dir, *extra)
    names = sorted(p.name for p in jax_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir())
    assert "sweep_summary.json" in names and len(names) > 3
    for name in names:
        want = (jax_dir / name).read_text().replace(str(jax_dir), "OUT")
        got = (port_dir / name).read_text().replace(str(port_dir), "OUT")
        assert got == want, name
    summary = json.loads((port_dir / "sweep_summary.json").read_text())
    assert all(e["status"] == "dry_run" for e in summary["epochs"])
    cfg = yaml.safe_load((port_dir / "epoch_000_config.yaml").read_text())
    assert cfg["llm_injector"]["subgraph_extraction_injection"] is True


def test_sweep_stages_call_the_ports_cli(tmp_path, monkeypatch):
    """Each stage is ``python -m vidgraph_tpu_torch.cli.main`` with the
    repo on the child's path; a failing kg stage ends the epoch as
    ``kg_build_failed``."""
    mod = _script("run_torch_parameter_sweep")
    calls = []

    def run(cmd, **kw):
        calls.append((cmd, kw))
        return subprocess.CompletedProcess(cmd, 1, "no uuid", "")

    monkeypatch.setattr(mod.subprocess, "run", run)
    mod.main(["--vlm-output", "v.json", "--queries", "q.json",
              "--output-dir", str(tmp_path), "--epochs", "1"])
    (cmd, kw), = calls
    assert cmd[1:4] == ["-m", "vidgraph_tpu_torch.cli.main", "kg"]
    assert kw["env"]["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT)
    summary = json.loads((tmp_path / "sweep_summary.json").read_text())
    assert summary["epochs"][0]["status"] == "kg_build_failed"


def test_profile_vit_smoke_prints_its_record(capsys):
    mod = _script("profile_torch_vit")
    rec = mod.main(["--smoke", "--attn", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(rec))
    assert rec["batch"] == 4 and rec["device"] == "cpu"
    stages = [r["stage"] for r in rec["stages"]]
    assert stages == ["fused (resize+norm+ViT)", "preprocess (resize+norm)",
                      "ViT tower (224 input)", "patchify+patch_embed",
                      "dispatch floor (trivial op)"]
    for row in rec["stages"][:4]:
        assert row["ms"] > 0 and row["bound_ms"] > 0
        assert row["mfu"] is None and row["tflops"] is None
    impls = {r["impl"]: r for r in rec["attn_impls"]}
    assert set(impls) == {"einsum", "packed", "fused"}
    assert impls["einsum"]["max_abs_drift_vs_einsum"] == 0.0
    # bf16 towers on the plain attention versions agree to bf16 rounding
    assert impls["fused"]["max_abs_drift_vs_einsum"] < 2e-2
    # MFU divides by the H100's peak, not the JAX script's v5e one
    assert mod.PEAK == 989e12 != _script("profile_vit").PEAK


@pytest.fixture(scope="module")
def judge_files(tmp_path_factory):
    """A retrieval-results file of four questions, and the judge config
    with its chat LM's seed weights (``CaptionerConfig.chat()``) saved as
    an npz; the sidecar caps the context and the decode budget, so that
    the LM judges on the CPU in seconds."""
    from vidgraph_tpu_torch.models.captioner import (CaptionerConfig,
                                                     init_params)
    from vidgraph_tpu_torch.models.checkpoint import save_params

    tmp = tmp_path_factory.mktemp("judge")
    ckpt = tmp / "instruct_lm.npz"
    save_params(init_params(CaptionerConfig.chat(),
                            0), str(ckpt))
    ckpt.with_suffix(".json").write_text(json.dumps({"seq_len": 640,
                                                     "max_new": 48}))
    cfg = yaml.safe_load((ROOT / "config" /
                          "judge_tpu_config.yaml").read_text())
    cfg["llm_injector"]["checkpoint_path"] = str(ckpt)
    cfg["graph_store"]["persist_dir"] = str(tmp / "graph_store")
    cfg_path = tmp / "judge.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    ctx = ("Chunks (2):\n  1. Time: 00:00-00:05\nContent: The scene shows a "
           "red object on a dark background. (score: 0.81)\n  2. The frames "
           "contain a static scene. (score: 0.64)\n")
    results = [
        {"query": "What color is the object?", "groundtruth": "red",
         "retrieval": ctx, "retrieval_time": 0.01},
        {"query": "What do the frames contain?",
         "groundtruth": "a static scene", "retrieval": ctx,
         "retrieval_time": 0.01},
        {"query": "What is in the background?", "groundtruth": "green",
         "retrieval": ctx, "retrieval_time": 0.01},
        {"query": "Skipped?", "groundtruth": "", "retrieval": ctx,
         "retrieval_time": 0.01}]
    inp = tmp / "results.json"
    inp.write_text(json.dumps(results))
    return cfg_path, inp


def test_judge_agreement_runs_and_its_strict_half_equals_jax(judge_files,
                                                             tmp_path):
    from vidgraph_tpu.core.config import PipelineConfig as JConfig
    from vidgraph_tpu.pipeline.benchmark import \
        BenchmarkEvaluator as JEvaluator

    cfg_path, inp = judge_files
    mod = _script("run_torch_judge_agreement")
    out = tmp_path / "out"
    summary = mod.main(["--input", str(inp), "--config", str(cfg_path),
                        "--outdir", str(out)])
    written = json.loads((out / "judge_agreement.json").read_text())
    assert written == summary
    assert set(summary) == {"n", "strict_accuracy", "llm_judge_accuracy",
                            "agreement", "flips"}
    assert summary["n"] == 4 and 0 <= summary["agreement"] <= 1
    llm = json.loads((out / "bench_llm_judge.json").read_text())
    assert llm["statistics"]["skipped_answers"] == 1
    assert sum(r["is_correct"] is not None for r in llm["results"]) == 3
    # the strict half: the JAX package's benchmark of the same file
    jcfg = JConfig.from_yaml(str(cfg_path))
    jcfg = copy.deepcopy(jcfg)
    jcfg.benchmark_llm.judge_backend = "local"
    want = asyncio.run(JEvaluator(jcfg).evaluate_retrieval_results(
        str(inp), str(tmp_path / "jax_strict.json")))
    got = json.loads((out / "bench_strict.json").read_text())
    assert got == json.loads(json.dumps(want))
    assert summary["strict_accuracy"] == want["statistics"]["accuracy"]


def test_judge_agreement_needs_the_tpu_judge(tmp_path):
    mod = _script("run_torch_judge_agreement")
    cfg = tmp_path / "strict.yaml"
    cfg.write_text((ROOT / "config" / "base_config.yaml").read_text())
    with pytest.raises(AssertionError, match="judge_backend"):
        mod.main(["--input", "unused.json", "--config", str(cfg),
                  "--outdir", str(tmp_path)])
