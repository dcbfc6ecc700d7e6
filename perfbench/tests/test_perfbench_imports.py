"""What the benchmark loads: never JAX or the JAX package (top-level
module names compared whole, so ``vidgraph_tpu_torch`` is not one), and in
the reference nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "vidgraph_tpu"}

LOAD = """
import os, sys, json
os.environ["VIDGRAPH_TORCH_DEVICE"] = "cpu"
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(imports: str) -> set:
    code = LOAD.format(root=str(ROOT), imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return set(__import__("json").loads(out.stdout.splitlines()[-1]))


def test_the_harness_and_the_port_load_no_jax():
    loaded = _loaded(
        "import perfbench.run\n"
        "from perfbench.harness import ingest, train, manifest\n"
        "import vidgraph_tpu_torch.services.vlm_client\n"
        "import vidgraph_tpu_torch.models.train\n"
        "for m in manifest.manifest()['per_layer']:\n"
        "    manifest.reader(m['name'])\n")
    assert "vidgraph_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded("from perfbench.reference import "
                     "captioner, lowp, optim, preprocess, prng, vit")
    assert not loaded & (FORBIDDEN | {"vidgraph_tpu_torch"})


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_sources_import_only_torch_numpy_and_themselves(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops = {"." if node.level else node.module.split(".")[0]}
        else:
            continue
        assert tops <= {"torch", "numpy", "math", "hashlib", "typing",
                        "__future__", "."}, (path.name, tops)
