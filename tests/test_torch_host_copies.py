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
    "graph/__init__.py",
    "graph/base.py",
    "graph/embedded.py",
    "graph/exporter.py",
    "graph/neo4j_backend.py",
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
    "pipeline/prune.py",
    "pipeline/refiner.py",
    "pipeline/retriever.py",
    "pipeline/retriever_hybrid.py",
    "pipeline/text_splitter.py",
    "pipeline/vlm_extractor.py",
    "services/embed_client.py",
    "services/server.py",
    "streams/ingest.py",
    "streams/realtime.py",
    "streams/scheduler.py",
    "utils/__init__.py",
    "utils/embedding_utils.py",
    "utils/frame_utils.py",
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


# hand-ported modules: the top-level definitions (functions, classes,
# constants; ``Class.method`` for one method of a class) listed here are
# the JAX module's, compared one by one by syntax tree without docstrings;
# every other definition of either file is the port's own, for the reason
# given in PORT_OWN
DEFINITION_COPIES = {
    "cli/main.py": [
        "logger", "run_vlm_extraction", "run_kg_construction",
        "run_offline_retrieval", "run_ask", "run_batch_offline_retrieval",
        "run_export_graph", "run_import_graph", "run_benchmark",
        "run_streams", "build_parser", "parse_true_chunks_args"],
    "services/llm_client.py": [
        "logger", "ChatClient", "HttpChatClient", "_STOPWORDS",
        "_VERB_HINTS", "_sentences", "_words", "_extract_triplets_heuristic",
        "_first_int", "_ARTICLES", "_STATE_RELS", "_CTX_EDGE_RE",
        "_canon_entity", "_canon_rel", "parse_subgraph_context", "_section",
        "_COLOR_WORDS", "_MATERIAL_WORDS", "_stem", "_idf_weights",
        "answer_candidates", "assemble_answer", "teacher_answer_scores",
        "_load_selector",
        "extractive_answer", "LocalChatClient", "fit_prompt_bytes",
        "make_chat_client"],
    "models/grammar.py": [
        "NSYM", "_Node", "Lit", "Cls", "Seq", "Alt", "Star", "Opt", "Plus",
        "chars", "_NFA", "_eps_closure", "_compile_dfa", "_jstr", "_jlist",
        "_triplet", "_grammar_consolidate", "_grammar_instruction",
        "_grammar_judge", "_grammar_pre", "_CONTRACTS", "Grammar.__init__",
        "Grammar.start_for_prompt", "Grammar._shortest_completions",
        "Grammar.repair", "pipeline_grammar"],
    "services/rerank_client.py": [
        "logger", "RerankerError", "RerankClient", "TPURerankClient",
        "TrainedRerankClient", "HttpRerankClient", "make_rerank_client"],
}
PORT_OWN = {
    "cli/main.py": {
        "main": "the JAX body inside cli/ranks.py::rank_scope: under "
                "torchrun only rank 0 writes files and prints",
    },
    "services/llm_client.py": {
        "TPUChatClient": "the chat LM's decode in PyTorch on the card",
    },
    "models/grammar.py": {
        "Grammar.device_table": "the table as a torch tensor on the port's "
                                "device, not a JAX array",
    },
    "services/rerank_client.py": {},
}


def _definitions(path: Path) -> dict:
    """{name: syntax tree without docstrings} of the module's top-level
    functions, classes and assigned names, and ``Class.method`` of each
    method."""
    def strip(node):
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)) and ast.get_docstring(sub):
                sub.body = sub.body[1:] or [ast.Pass()]
        return ast.dump(node)

    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        out[f"{node.name}.{sub.name}"] = sub
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for target in (node.targets if isinstance(node, ast.Assign)
                           else [node.target]):
                if isinstance(target, ast.Name):
                    out[target.id] = node
    return {name: strip(node) for name, node in out.items()}


@pytest.mark.parametrize("rel", sorted(DEFINITION_COPIES))
def test_listed_definitions_are_copies(rel):
    """Each listed definition equals the JAX module's; every definition of
    either file is listed or has its reason in PORT_OWN, so one added to
    the JAX module is flagged too."""
    port, jax_side = (_definitions(ROOT / pkg / rel)
                      for pkg in ("vidgraph_tpu_torch", "vidgraph_tpu"))
    listed = DEFINITION_COPIES[rel]
    drifted = [name for name in listed
               if name not in port or port[name] != jax_side.get(name)]
    assert not drifted, (f"vidgraph_tpu_torch/{rel} drifted from "
                         f"vidgraph_tpu/{rel} in {drifted}")
    own = set(PORT_OWN[rel])
    split = {name.split(".")[0] for name in listed if "." in name}

    def covered(name):
        cls = name.split(".")[0]
        if name in listed or name in own or name in split:
            return True
        # a method of a class compared whole, or of one that is the port's
        return "." in name and cls not in split and (cls in listed
                                                     or cls in own)
    unlisted = sorted(n for n in set(port) | set(jax_side) if not covered(n))
    assert not unlisted, f"{rel}: not listed and no reason given: {unlisted}"
    assert rel not in VERBATIM and rel not in CODE_COPIES


# modules of the port with no module of the same path in the JAX package
NEW = {"convert.py", "core/prng.py", "ops/_build.py",
       "ops/flash_attention.py", "ops/decode_attention.py", "cli/ranks.py",
       "parallel/comm.py", "parallel/dryrun.py",
       "parallel/launch.py", "parallel/leader.py",
       "parallel/tensor_parallel.py"}
# modules rewritten for PyTorch (the kernels' wrappers and the models that
# reach them), held to the JAX package by their own tests/test_torch_*.py
REWRITTEN = {"ops/preprocess.py", "ops/short_attention.py", "models/vit.py",
             "services/vlm_client.py", "models/text_embedder.py",
             "models/reranker.py", "models/answer_selector.py",
             "parallel/mesh.py", "parallel/moe.py", "parallel/pipeline.py",
             "parallel/serving.py", "parallel/sharded_search.py"}


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


def test_repro_script_is_the_jax_script_on_the_port():
    """``scripts/repro_torch_best_config.sh`` is ``repro_best_config.sh``
    with the JAX package's CLI replaced by the port's, and nothing else."""
    jax_side = (ROOT / "scripts" / "repro_best_config.sh").read_text()
    port = (ROOT / "scripts" / "repro_torch_best_config.sh").read_text()
    assert "vidgraph_tpu." in jax_side
    assert port == jax_side.replace("vidgraph_tpu.", "vidgraph_tpu_torch.")
    assert (ROOT / "scripts" / "repro_torch_best_config.sh").stat().st_mode \
        & 0o111
