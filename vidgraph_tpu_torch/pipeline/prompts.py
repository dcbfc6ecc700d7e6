"""Prompt library — every LLM-facing template in one place.

Output contracts match the reference exactly (reference:
src/components/prompts.py:13-120): pipe-delimited triplet lines for
pre-extraction, a ``{"triplets": [[h, r, t, [sources]], ...]}`` JSON object
for consolidation, a 4-operation JSON object for instruction-based
refinement, a free-text benchmark answer, and a strict
``{"is_correct": bool}`` judge verdict.  Wording is this framework's own;
parsers only rely on the structural contracts above.

Templates are plain ``str.format`` strings (no langchain dependency).
"""
from __future__ import annotations

PRE_LLM_PROMPT_TEMPLATE = """\
You are a knowledge-graph extraction engine. Read the video narration text
and list the concrete entities and the direct relationships between them.

RULES (follow exactly):
- One triplet per line, nothing else on the line.
- Line format: Entity1 | relation_in_snake_case | Entity2
- No numbering, no quotes, no commentary.
- At most {max_triplets} lines.

SAMPLE LINES:
Technician | operates | Centrifuge
Workbench | supports | Flask

TEXT TO ANALYSE:
{input}

TRIPLET LINES:
"""

LLM_INJECTOR_PROMPT_TEMPLATE = """\
You are consolidating candidate knowledge-graph triplets into a clean set.

GRAPH CONTEXT:
{network_info}

CANDIDATE TRIPLETS:
{pre_extracted_triplets}

DO THIS:
1. Collapse duplicates and normalise entity names (e.g. "Man" -> "Person").
2. Keep relations snake_case.
3. Preserve each triplet's source chunk indices.

RESPOND WITH ONE JSON OBJECT, nothing else, shaped exactly like:
{{"triplets": [
  ["Technician", "operates", "Centrifuge", [0, 1]],
  ["Centrifuge", "model", "SpinMax 300", [2]]
]}}
The "triplets" list must contain at most {max_new_triplets} entries.

JSON:
"""

LLM_INJECTOR_INSTRUCTION_PROMPT_TEMPLATE = """\
You are refining a knowledge graph. Compare the new candidate triplets with
the existing subgraph context and emit graph-edit operations.

{empty_context_rule}

### EXISTING SUBGRAPH CONTEXT:
{subgraph_context}

### NEW CANDIDATE TRIPLETS (current batch):
{pre_extracted_triplets}

### RESPOND WITH ONE JSON OBJECT containing exactly these 4 keys:
1. "new_triplets" (max {max_new_triplets}): facts absent from the context.
   Shape: [[Head, Relation, Tail, [SourceIndices]], ...]. Prefer
   actions/interactions; drop redundant duplicates.
2. "inter_chunk_relations" (max {max_inter_chunk_relations}): edges from a
   NEW entity to an entity already in the context. Shape:
   [[NewHead, Relation, ExistingTail, [SourceIndices]], ...]. ExistingTail
   must match a context entity name exactly.
3. "merge_instructions" (max {max_merge_instructions}): semantic duplicates
   to merge. Shape: [{{"local": LocalName, "existing": ExistingName,
   "existing_id": ExistingID}}, ...]. Take the id verbatim from the context.
4. "prune_instructions" (max {max_prune_instructions}): contradicted facts
   to remove. Each item is either {{"entity": EntityName}} (drop the entity
   and all its edges) or {{"head": H, "relation": R, "tail": T}} (drop one
   relationship).

Output the JSON object only — no prose before or after.

JSON:
"""

EMPTY_CONTEXT_RULE = """\
IMPORTANT: the existing subgraph context below is EMPTY. Therefore
"inter_chunk_relations", "merge_instructions" and "prune_instructions" MUST
all be empty lists — there is nothing to link to, merge with, or prune.\
"""

BENCHMARK_ANSWER_PROMPT_TEMPLATE = """\
Using ONLY the video context below, answer the question.

QUESTION: {question}

VIDEO CONTEXT:
{context}

CONCISE ANSWER:
"""

BENCHMARK_EVALUATION_PROMPT_TEMPLATE = """\
Decide whether the AI answer agrees with the ground truth, given the context.

QUESTION: {question}
GROUND TRUTH: {groundtruth}
AI ANSWER: {generated_answer}
CONTEXT: {context}

Respond with strict JSON only: {{"is_correct": true}} or {{"is_correct": false}}
"""


def build_pre_llm_prompt(text: str, max_triplets: int) -> str:
    return PRE_LLM_PROMPT_TEMPLATE.format(input=text,
                                          max_triplets=max_triplets)


def build_injector_prompt(pre_extracted_triplets: str, network_info: str,
                          max_new_triplets: int) -> str:
    return LLM_INJECTOR_PROMPT_TEMPLATE.format(
        pre_extracted_triplets=pre_extracted_triplets,
        network_info=network_info, max_new_triplets=max_new_triplets)


def build_instruction_prompt(pre_extracted_triplets: str,
                             subgraph_context: str,
                             max_new_triplets: int,
                             max_inter_chunk_relations: int,
                             max_merge_instructions: int,
                             max_prune_instructions: int,
                             context_is_empty: bool = False) -> str:
    return LLM_INJECTOR_INSTRUCTION_PROMPT_TEMPLATE.format(
        empty_context_rule=EMPTY_CONTEXT_RULE if context_is_empty else "",
        subgraph_context=subgraph_context or "(empty)",
        pre_extracted_triplets=pre_extracted_triplets,
        max_new_triplets=max_new_triplets,
        max_inter_chunk_relations=max_inter_chunk_relations,
        max_merge_instructions=max_merge_instructions,
        max_prune_instructions=max_prune_instructions)


def build_benchmark_answer_prompt(question: str, context: str) -> str:
    return BENCHMARK_ANSWER_PROMPT_TEMPLATE.format(question=question,
                                                   context=context)


def build_benchmark_evaluation_prompt(question: str, groundtruth: str,
                                      generated_answer: str,
                                      context: str) -> str:
    return BENCHMARK_EVALUATION_PROMPT_TEMPLATE.format(
        question=question, groundtruth=groundtruth,
        generated_answer=generated_answer, context=context)
