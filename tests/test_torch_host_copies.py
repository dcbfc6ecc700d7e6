"""Drift guard: the port's host modules are verbatim copies of the JAX
package's, so a fix to either must reach both."""
import ast
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


# copies whose code is the JAX module's, under a module docstring of their own
CODE_COPIES = ["models/instruct_data.py"]


def _code(path: Path) -> str:
    """The module's syntax tree without its docstring."""
    tree = ast.parse(path.read_text())
    if ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", CODE_COPIES)
def test_host_module_code_is_a_copy(rel):
    port, jax_side = (ROOT / pkg / rel
                      for pkg in ("vidgraph_tpu_torch", "vidgraph_tpu"))
    assert _code(port) == _code(jax_side), (
        f"vidgraph_tpu_torch/{rel} drifted from vidgraph_tpu/{rel}")
    assert rel not in VERBATIM


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
