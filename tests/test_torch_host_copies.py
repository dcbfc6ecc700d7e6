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
    "memory/__init__.py",
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
    "services/embed_client.py",
]


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_module_is_a_verbatim_copy(rel):
    port = (ROOT / "vidgraph_tpu_torch" / rel).read_bytes()
    assert port == (ROOT / "vidgraph_tpu" / rel).read_bytes(), (
        f"vidgraph_tpu_torch/{rel} drifted from vidgraph_tpu/{rel}")


def test_every_port_module_has_a_counterpart():
    port = ROOT / "vidgraph_tpu_torch"
    new = {"convert.py", "ops/_build.py"}
    for path in port.rglob("*.py"):
        rel = path.relative_to(port).as_posix()
        if rel in new or rel == "__init__.py":
            continue
        assert (ROOT / "vidgraph_tpu" / rel).exists(), rel
