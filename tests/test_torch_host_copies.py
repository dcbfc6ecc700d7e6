"""Drift guard: the port's host modules are verbatim copies of the JAX
package's, so a fix to either must reach both."""
from pathlib import Path

import pytest

ROOT = Path(__file__).parent.parent
VERBATIM = [
    "cli/__init__.py",
    "core/__init__.py",
    "core/logger.py",
    "core/metrics.py",
    "graph/base.py",
    "graph/embedded.py",
    "graph/exporter.py",
    "io/__init__.py",
    "io/video.py",
    "memory/__init__.py",
    "models/tokenizer.py",
    "native/__init__.py",
    "native/ngram_hash.cc",
    "pipeline/benchmark.py",
    "pipeline/injector.py",
    "pipeline/kg_builder.py",
    "pipeline/network_info.py",
    "pipeline/pre_injector.py",
    "pipeline/prompts.py",
    "pipeline/refiner.py",
    "pipeline/retriever.py",
    "pipeline/retriever_hybrid.py",
    "pipeline/text_splitter.py",
    "pipeline/vlm_extractor.py",
    "services/embed_client.py",
    "streams/scheduler.py",
]


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_module_is_a_verbatim_copy(rel):
    port = (ROOT / "vidgraph_tpu_torch" / rel).read_bytes()
    assert port == (ROOT / "vidgraph_tpu" / rel).read_bytes(), (
        f"vidgraph_tpu_torch/{rel} drifted from vidgraph_tpu/{rel}")


# modules of the port with no module of the same path in the JAX package
NEW = {"convert.py", "ops/_build.py", "ops/flash_attention.py"}
# modules rewritten for PyTorch (the kernels' wrappers and the models that
# reach them), held to the JAX package by their own tests/test_torch_*.py
REWRITTEN = {"ops/preprocess.py", "ops/short_attention.py", "models/vit.py",
             "services/vlm_client.py"}


def test_every_port_module_has_a_counterpart():
    port = ROOT / "vidgraph_tpu_torch"
    for path in port.rglob("*.py"):
        rel = path.relative_to(port).as_posix()
        if rel in NEW or rel == "__init__.py":
            continue
        assert (ROOT / "vidgraph_tpu" / rel).exists(), rel


@pytest.mark.parametrize("rel", sorted(NEW | REWRITTEN))
def test_listed_modules_exist_and_are_not_copies(rel):
    """The two lists name real modules of the port, and a rewritten one is
    no verbatim copy (it would belong in VERBATIM)."""
    port = ROOT / "vidgraph_tpu_torch" / rel
    assert port.exists(), rel
    assert rel not in VERBATIM
    jax_side = ROOT / "vidgraph_tpu" / rel
    assert (rel in NEW) != jax_side.exists(), rel
    if jax_side.exists():
        assert port.read_bytes() != jax_side.read_bytes()
