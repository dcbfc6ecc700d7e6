"""Typed configuration tree (YAML -> pydantic), as in
``vidgraph_tpu/core/config.py``: the same sections, fields and defaults, so
every YAML file under ``config/`` loads unchanged in both packages.

``from_dict`` records the ``mesh:`` section as the serving-mesh policy
(``parallel/serving.py::configure``), as the JAX package does; the mesh is
built on first use, over the ranks of the process group
(``torchrun --nproc-per-node N``).  Backend names keep their meaning:
``tpu`` selects the in-process accelerator, which here is the card
``core/platform.py::device()`` names.

Mirrors the reference's config surface (reference: src/core/config.py:5-114 and
config/base_config.yaml) so that reference YAML files load unchanged, and adds
TPU-native sections (``backend``, ``mesh``, ``graph_store``, ``acs``) that have
safe offline defaults.  Unknown keys are tolerated (the reference relied on
pydantic-v1 ``parse_obj`` leniency, e.g. ``max_connection_subgraph`` —
reference: src/components/pre_llm_injector.py:454).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import yaml
from pydantic import BaseModel, ConfigDict


class _Model(BaseModel):
    model_config = ConfigDict(extra="allow")


class VideoConfig(_Model):
    chunk_size_seconds: float = 5.0
    frames_per_chunk: int = 5
    fps_target: Optional[float] = None


class VLMConfig(_Model):
    endpoint: str = "http://localhost:8078/v1"
    api_key: str = ""
    model_name: str = "qwen-vlm"
    temperature: float = 0.2
    top_p: float = 0.9
    max_tokens: int = 2048
    system_prompt: str = (
        "You are a helpful assistant that describes video content in detail."
    )
    user_prompt_template: str = (
        "Describe what's happening in these frames from a video."
    )
    # TPU-backend preprocessing numerics (ADVICE r2: pin them so the same
    # video embeds identically across deployments).  preprocess: "auto"
    # host-resizes large frames when cv2 is importable; "host" always
    # host-resizes (errors without cv2); "device" always resizes on device.
    preprocess: str = "auto"   # auto | host | device
    fast_resize: bool = True   # bf16 separable resize vs exact f32
    # weight-only int8 serving for the captioner (models/quant8.py):
    # None | "int8" (bf16 activations) | "int8_a8" (int8 MXU dot)
    quantize: Optional[str] = None


class LLMInjectorConfig(_Model):
    endpoint: str = "http://localhost:8078/v1"
    api_key: str = ""
    model_name: str = "qwen-vlm"
    temperature: float = 0.05
    top_p: float = 0.9
    max_tokens: int = 8192
    # trained byte-LM weights for backend.llm: tpu
    # (scripts/train_caption_lm.py)
    checkpoint_path: str = ""
    # trained answer-selection cross-encoder for the benchmark answer
    # role under backend.llm: tpu (scripts/train_answer_selector.py);
    # "" keeps free byte generation for answer prompts
    answer_selector_path: str = ""
    # "blend": selector scores ride as the semantic channel over the
    # lexical prior; "pure": model scores drive selection alone
    answer_selector_mode: str = "blend"
    # When true, pre-extraction runs the chunk<->existing-graph similarity
    # path and refinement becomes instruction-based (4-op output).
    subgraph_extraction_injection: bool = False


class ChunkingConfig(_Model):
    enabled: bool = True
    chunk_size: int = 296
    chunk_overlap: int = 16
    # 'token' reproduces the reference's TokenTextSplitter boundaries
    # (tiktoken when available, calibrated estimator otherwise);
    # 'word' is the round-1 word-window fallback.
    splitter: str = "token"
    max_triplets_per_chunk: int = 6
    use_sentence_boundaries: bool = True
    parallel_count: int = 2
    enable_global_refinement: bool = True
    refinement_max_tokens: int = 6000
    global_triplet_limit: int = 15
    max_new_triplets: int = 10
    max_inter_chunk_relations: int = 5
    max_merge_instructions: int = 4
    max_prune_instructions: int = 4
    chunk_timeout_seconds: float = 5.0
    chunk_timeout_retries: int = 3
    batch_llm_parallelism: bool = False
    max_connection_subgraph: int = 2


class KGConfig(_Model):
    batch_size: int = 3
    verbose: bool = False
    embedding_endpoint: str = "http://localhost:8071/v1"
    embedding_model: str = "qwen-embedding"
    embedding_api_key: str = ""


class EmbedderConfig(_Model):
    endpoint: str = "http://localhost:8071/v1"
    api_key: str = ""
    model: str = "qwen-embedding"
    # trained-weights checkpoint for backend.embedder: transformer
    # (scripts/train_text_embedder.py writes the .npz + sidecar .json)
    checkpoint_path: str = ""
    top_k_chunk_with_batch_similarity: int = 3
    top_k_similar_batch: int = 2


class Neo4jConfig(_Model):
    uri: str = "bolt://localhost:7687"
    user: str = "neo4j"
    password: str = "password"
    database: str = "neo4j"


class RetrievalConfig(_Model):
    use_reranker: bool = True
    reranker_endpoint: str = "http://localhost:8070/v1/rerank"
    reranker_api_key: str = ""
    reranker_model: str = "qwen-reranker"
    # trained cross-encoder weights for backend.reranker: trained
    # (scripts/train_reranker.py)
    reranker_checkpoint_path: str = ""
    # When > 0 and a reranker is active, vector search over-fetches this
    # many chunk candidates, the COMBINED (vector + traversal) pool is
    # reranked as one list, and only then capped at top_k_chunks — so the
    # reranker genuinely selects the context instead of re-ordering an
    # already-capped list.  0 preserves the reference flow.
    rerank_pool: int = 0
    top_k: int = 5
    top_k_chunks: int = 3
    top_k_entities: int = 5
    top_k_relationships: int = 5
    graph_hops: int = 2
    post_compression: bool = True
    compression_threshold: float = 0.15
    verbose: bool = False
    entity_first: bool = True
    rerank_after_traversal: bool = True
    rerank_entities: bool = True
    rerank_relationships: bool = True


class BenchmarkLLMConfig(_Model):
    endpoint: str = "http://localhost:8078/v1"
    api_key: str = ""
    model_name: str = "qwen-vlm"
    temperature: float = 0.2
    top_p: float = 0.9
    max_tokens: int = 2048
    # Judge backend override ("" = same client as answer generation).
    # Pinning "local" keeps the strict deterministic token-boundary judge
    # as the metric while backend.llm swaps the answer generator — scores
    # stay comparable across backends (deliberate deviation from the
    # reference's single LLM for both roles; documented in PARITY.md).
    judge_backend: str = ""


# ---------------------------------------------------------------------------
# TPU-native sections (new in this framework; absent from reference YAMLs, so
# every field has an offline-safe default).
# ---------------------------------------------------------------------------

class BackendConfig(_Model):
    """Which implementation serves each model role.

    ``tpu``   — in-process model on the local accelerator (the card)
    ``http``  — OpenAI-compatible HTTP endpoint (reference behaviour)
    ``local`` — deterministic, dependency-free fallback (tests / offline)
    """

    vlm: str = "local"        # captioning: tpu | http | local
    llm: str = "local"        # triplet extraction/refinement/benchmark LLM
    embedder: str = "tpu"     # embeddings: tpu | http | hash
    reranker: str = "tpu"     # rerank: tpu | http | none


class MeshConfig(_Model):
    # "auto" builds a serving mesh iff the process group has >1 rank;
    # true/false force it on (a world of one when no group is) / off
    enabled: Any = "auto"
    data_axis: int = 0        # 0 = use all remaining devices
    model_axis: int = 1
    axis_names: List[str] = ["data", "model"]


class GraphStoreConfig(_Model):
    backend: str = "embedded"  # embedded | neo4j
    persist_dir: str = "graph_store"
    persist: bool = True


class ACSConfig(_Model):
    # auto | xla | networkx; xla is the device sweep as torch ops, which
    # auto takes from 96 nodes up (pipeline/acs.py)
    backend: str = "auto"
    louvain: str = "device"    # device (approx) | networkx (exact seed)
    exact_efficiency_max_nodes: int = 500
    sample_sources: int = 100
    betweenness_k: int = 100
    robustness_removal_fraction: float = 0.1


class EmbeddingMemoryConfig(_Model):
    dim: int = 512
    initial_capacity: int = 4096
    dtype: str = "float32"


class PipelineConfig(_Model):
    video: VideoConfig = VideoConfig()
    vlm: VLMConfig = VLMConfig()
    llm_injector: LLMInjectorConfig = LLMInjectorConfig()
    chunking: ChunkingConfig = ChunkingConfig()
    kg: KGConfig = KGConfig()
    embedder: EmbedderConfig = EmbedderConfig()
    neo4j: Neo4jConfig = Neo4jConfig()
    retrieval: RetrievalConfig = RetrievalConfig()
    benchmark_llm: BenchmarkLLMConfig = BenchmarkLLMConfig()
    saving_batch_metrics: bool = True

    backend: BackendConfig = BackendConfig()
    mesh: MeshConfig = MeshConfig()
    graph_store: GraphStoreConfig = GraphStoreConfig()
    acs: ACSConfig = ACSConfig()
    embedding_memory: EmbeddingMemoryConfig = EmbeddingMemoryConfig()

    @classmethod
    def from_yaml(cls, path: str) -> "PipelineConfig":
        with open(path, "r") as f:
            raw: Dict[str, Any] = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "PipelineConfig":
        cfg = cls.model_validate(raw or {})
        # Record the serving-mesh policy process-wide so every entry point
        # (CLI, engines, servers) picks it up without explicit wiring; the
        # mesh itself is built lazily on first use.
        from ..parallel import serving

        serving.configure(cfg.mesh)
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return self.model_dump()
