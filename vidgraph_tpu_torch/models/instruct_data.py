"""Self-distilled instruction dataset for the on-device chat LM.

``backend.llm: tpu`` needs a byte-level LM that follows the pipeline's
prompt contracts.  The teacher is the deterministic ``LocalChatClient``:
every target below is its output on a prompt built by the same functions
the live pipeline calls (``pipeline/prompts.py``), so the training
distribution is the serving distribution.

The code below the docstring is that of
``vidgraph_tpu/models/instruct_data.py``, line for line (it imports only
host modules that the port has too), so that both packages build the same
dataset from the same seed; ``tests/test_torch_host_copies.py`` keeps the
two equal.

Tasks:
* ``pre_llm``      — pipe-delimited triplet extraction from caption chunks
* ``consolidate``  — ``{"triplets": [...]}`` dedupe/cap JSON
* ``instruction``  — 4-op refinement JSON (new/inter/merge/prune)
* ``answer``       — extractive benchmark answers over retrieval contexts
* ``copy``         — auxiliary verbatim-copy curriculum (byte-level
  copying is the backbone of every contract; this accelerates
  induction-head formation)
"""
from __future__ import annotations

import json
import random
import re
from typing import Dict, List, Optional, Sequence, Tuple

from ..pipeline.prompts import (build_benchmark_answer_prompt,
                                build_injector_prompt,
                                build_instruction_prompt,
                                build_pre_llm_prompt)
from ..services.llm_client import LocalChatClient, extractive_answer

Example = Tuple[str, str, str]          # (task, prompt, response)

_COLORS = ["red", "blue", "green", "yellow", "white", "black", "gray",
           "orange", "purple", "brown", "transparent", "silver", "cyan",
           "magenta", "pink", "golden", "dark blue", "pale green", "amber",
           "turquoise"]
_OBJECTS = ["beaker", "flask", "balance", "smartphone", "glove", "pipette",
            "notebook", "monitor", "bottle", "stirrer", "scale", "tray",
            "goggles", "cylinder", "funnel", "burner", "thermometer",
            "syringe", "clamp", "rack", "crucible", "tongs", "spatula",
            "dropper", "vial", "petri dish", "microscope", "centrifuge",
            "hotplate", "wash bottle", "test tube", "stand", "keyboard",
            "timer", "marker", "label", "stopwatch", "container"]
_VERBS = ["holds", "contains", "displays", "uses", "wears", "touches",
          "observes", "supports", "measures", "pours", "adjusts",
          "examines", "carries", "opens", "places", "lifts", "shakes",
          "rotates", "cleans", "seals", "inspects", "weighs", "fills",
          "empties", "connects"]
_ACTORS = ["person", "scientist", "researcher", "technician", "student",
           "operator", "worker", "experimenter"]


def sentences_of(captions: Sequence[str]) -> List[str]:
    out: List[str] = []
    for cap in captions:
        for s in re.split(r"(?<=[.!?])\s+|\n+", cap):
            s = s.strip()
            if len(s) > 15:
                out.append(s)
    return out


def synth_sentence(rng: random.Random) -> str:
    c1, c2 = rng.sample(_COLORS, 2)
    o1, o2 = rng.sample(_OBJECTS, 2)
    v = rng.choice(_VERBS)
    a = rng.choice(_ACTORS)
    num = f"{rng.uniform(-99, 99):.3f}"
    unit = rng.choice(["g", "ml", "kg", "cm", "mm"])
    forms = [
        f"The {a} {v} a {c1} {o1} near the {c2} {o2}.",
        f"A {c1} {o1} sits on the bench while the {a} {v} the {o2}.",
        f"The {o1} {v} a {c1} label and the {a} picks up the {c2} {o2}.",
        f"On the table, a {c1} {o1} {v} the {o2}.",
        f"The {c1} {o1} shows a reading of {num} {unit}.",
        f"The {a} {v} the {o1} labelled \"{o2.title()} {rng.randint(1, 99)}\".",
        f"Behind the {c2} {o2}, the {a} carefully {v} the {c1} {o1}.",
        f"The {a} in {c1} gloves {v} a {c2} {o1} beside the {o2}.",
    ]
    return rng.choice(forms)


def make_chunks(captions: Sequence[str], rng: random.Random,
                chunk_sizes: Sequence[int] = (140, 200, 296),
                synth_fraction: float = 0.8,
                min_total: int = 0) -> List[str]:
    """Batch texts shaped like KGBuilder's aggregation, split with the
    real token splitter — plus synthetic-caption chunks for diversity
    (topped up to ``min_total`` so large datasets stay example-unique)."""
    from ..pipeline.text_splitter import TokenTextSplitter

    caps = list(captions)
    chunks: List[str] = []
    for size in chunk_sizes:
        splitter = TokenTextSplitter(chunk_size=size,
                                     chunk_overlap=max(8, size // 10))
        for start in range(0, max(1, len(caps) - 2), 3):
            items = caps[start:start + 3]
            text = "\n".join(
                f"Time: {i:02d}:{(start * 5) % 60:02d}-"
                f"{i:02d}:{(start * 5 + 4) % 60:02d}\nContent: {c}"
                for i, c in enumerate(items))
            chunks.extend(splitter.split_text(text))
    n_synth = max(int(len(chunks) * synth_fraction),
                  min_total - len(chunks))
    for _ in range(n_synth):
        text = " ".join(synth_sentence(rng)
                        for _ in range(rng.randint(2, 5)))
        chunks.append(text)
    rng.shuffle(chunks)
    return chunks


def _teacher() -> LocalChatClient:
    return LocalChatClient()


def pre_llm_examples(chunks: Sequence[str], rng: random.Random,
                     n: int) -> List[Example]:
    t = _teacher()
    out: List[Example] = []
    for chunk in list(chunks)[:n]:
        # 4 is the serve-time cap in the sweep-best / tpu_llm configs —
        # train it (round 4: train==serve on the triplet-count axis)
        max_trip = rng.choice((4, 4, 5, 6, 8))
        prompt = build_pre_llm_prompt(chunk, max_trip)
        out.append(("pre_llm", prompt, t.complete_sync(prompt)))
    return out


def _candidates_from(chunks: Sequence[str], rng: random.Random,
                     n_items: int, cap: int = 25) -> List[Dict]:
    """Teacher-extracted triplet dicts with short source-chunk ids, the
    shape the refiner feeds into its prompts.  ``cap`` mirrors the
    refiner's ``global_triplet_limit`` input cap so the trained candidate
    COUNT distribution matches serve time (VERDICT r3 next #3: the serve
    refiner sees up to ~25 candidates from ~17 chunks/batch; round-3
    training topped out at ~4 chunks' worth)."""
    from ..pipeline.pre_injector import PreLLMInjector

    t = _teacher()
    cands: List[Dict] = []
    batch = rng.randrange(100)
    for i, chunk in enumerate(rng.sample(list(chunks),
                                         min(n_items, len(chunks)))):
        raw = t.complete_sync(build_pre_llm_prompt(chunk, 6))
        for tr in PreLLMInjector.parse_pipe_delimited(raw,
                                                      f"run_{batch}_{i}"):
            tr["source_chunks"] = [f"{batch}_{i}"]
            cands.append(tr)
        if len(cands) >= cap:
            break
    return cands[:cap]


def _entity_variant(name: str, rng: random.Random) -> str:
    """A surface variant with the SAME canonical form (llm_client.
    _canon_entity) — the duplicate shape the merge teacher detects."""
    from ..services.llm_client import _canon_entity

    forms = []
    low = name.lower()
    if not low.startswith(("the ", "a ", "an ")):
        forms.append("The " + name)
    last = name.split()[-1]
    if not last.lower().endswith("s"):
        forms.append(name + "s")
    elif len(last) > 3 and not last.lower().endswith("ss"):
        forms.append(name[:-1])
    canon = _canon_entity(name)
    forms = [f for f in forms
             if f != name and _canon_entity(f) == canon]
    return rng.choice(forms) if forms else "The " + name


def _context_for_candidates(cands: Sequence[Dict],
                            rng: random.Random) -> str:
    """Subgraph context in the REAL serve format (refiner.py wraps
    pre_injector's ``Subgraph: (Name / ID: b_c)-[REL]->(...)`` strings
    as ``Subgraph_{i}: ...``) — round 5 fixes the round-3/4 synthetic
    ``(Entity: X / ID: y)`` format that never matched serve time.

    Edges are DERIVED from the candidates so every op class has training
    signal: canonical-variant entities (merge), exactly-named candidate
    tails (inter-chunk link), superseded state facts (prune), plus
    unrelated distractors (teaching the model NOT to over-edit)."""
    from ..services.llm_client import _STATE_RELS, _canon_rel

    def sid() -> str:
        return f"{rng.randrange(50)}_{rng.randrange(6)}"

    def rand_entity() -> str:
        return (f"{rng.choice(_COLORS).title()} "
                f"{rng.choice(_OBJECTS).title()}")

    def rel_label(r: str) -> str:
        return str(r).replace(" ", "_").upper()

    edges: List[str] = []
    pool = rng.sample(list(cands), min(len(cands), rng.randint(1, 3)))
    for tr in pool:
        h = str(tr.get("head", "Item"))
        r = str(tr.get("relation", "near"))
        t = str(tr.get("tail", "Bench"))
        scenario = rng.choice(("merge", "inter", "prune", "distract"))
        if scenario == "prune" and _canon_rel(r) not in _STATE_RELS:
            scenario = rng.choice(("merge", "inter", "distract"))
        if scenario == "merge":
            v = _entity_variant(h if rng.random() < 0.5 else t, rng)
            edges.append(f"({v} / ID: {sid()})-[{rel_label(rng.choice(_VERBS))}]"
                         f"->({rand_entity()} / ID: {sid()})")
        elif scenario == "inter":
            # the candidate's tail, exactly named, already in the graph
            if rng.random() < 0.5:
                edges.append(f"({t} / ID: {sid()})-"
                             f"[{rel_label(rng.choice(_VERBS))}]->"
                             f"({rand_entity()} / ID: {sid()})")
            else:
                edges.append(f"({rand_entity()} / ID: {sid()})-"
                             f"[{rel_label(rng.choice(_VERBS))}]->"
                             f"({t} / ID: {sid()})")
        elif scenario == "prune":
            old_tail = rand_entity() if rng.random() < 0.6 else \
                f"{rng.uniform(-99, 99):.3f} {rng.choice(('G', 'Ml'))}"
            edges.append(f"({h} / ID: {sid()})-[{rel_label(r)}]->"
                         f"({old_tail} / ID: {sid()})")
        else:
            edges.append(f"({rand_entity()} / ID: {sid()})-"
                         f"[{rel_label(rng.choice(_VERBS))}]->"
                         f"({rand_entity()} / ID: {sid()})")
    # distribute edges over 1-3 Subgraph_N lines like the live refiner
    rng.shuffle(edges)
    n_lines = rng.randint(1, min(3, len(edges)))
    lines = []
    per = -(-len(edges) // n_lines)
    for i in range(n_lines):
        part = edges[i * per:(i + 1) * per]
        if part:
            lines.append(f"Subgraph_{i + 1}: Subgraph: " + ", ".join(part))
    return "\n".join(lines)


def instruction_examples(chunks: Sequence[str], rng: random.Random,
                         n: int) -> List[Example]:
    """4-op refinement examples.  Candidate pools span the serve range
    (2-8 chunks' worth, capped at the refiner input limit) and op caps
    are dominated by the serve configuration (15 new triplets,
    config/tpu_llm_config.yaml) with the round-3 caps mixed in for
    robustness.  Contexts are candidate-derived (round 5) so the targets
    carry real merge / inter-chunk / prune operations."""
    t = _teacher()
    out: List[Example] = []
    for _ in range(n):
        cands = _candidates_from(chunks, rng, rng.randint(2, 8))
        if not cands:
            continue
        empty = rng.random() < 0.3
        ctx = ("" if empty else _context_for_candidates(cands, rng))
        max_new = 15 if rng.random() < 0.7 else 10
        prompt = build_instruction_prompt(
            json.dumps(cands), ctx, max_new, 5, 4, 4,
            context_is_empty=empty)
        out.append(("instruction", prompt, t.complete_sync(prompt)))
    return out


def consolidate_examples(chunks: Sequence[str], rng: random.Random,
                         n: int) -> List[Example]:
    t = _teacher()
    out: List[Example] = []
    for _ in range(n):
        cands = _candidates_from(chunks, rng, rng.randint(2, 4))
        if not cands:
            continue
        info = (f"Graph has {rng.randrange(600)} nodes and "
                f"{rng.randrange(1600)} relationships.")
        prompt = build_injector_prompt(json.dumps(cands), info, 15)
        out.append(("consolidate", prompt, t.complete_sync(prompt)))
    return out


def format_context(chunk_texts: Sequence[str], query: str,
                   entities: Sequence[str] = (), times: Sequence[str] = ()
                   ) -> str:
    """Synthetic retrieval context in HybridRetriever's exact output
    format (pipeline/retriever_hybrid.py::_format_retrieval_results)."""
    parts = [f"Chunks ({len(chunk_texts)}):"]
    for i, c in enumerate(chunk_texts, 1):
        t = f" [time: {times[i - 1]}]" if i - 1 < len(times) else ""
        parts.append(f"  {i}. {c} (score: 0.{90 - i * 7:02d}0){t}")
    if entities:
        parts.append(f"\nRelated Entities ({len(entities)}):")
        for i, e in enumerate(entities, 1):
            parts.append(f"  {i}. {e}")
    return f"Found results for '{query}':\n" + "\n".join(parts)


def synth_questions(sents: Sequence[str], rng: random.Random,
                    n: int) -> List[str]:
    """Template questions grounded in corpus sentences (color/object/verb
    mentions), the benchmark's question style."""
    qs: List[str] = []
    color_re = re.compile(r"\b(" + "|".join(_COLORS) + r")\s+(\w+)",
                          re.IGNORECASE)
    for s in rng.sample(list(sents), min(len(sents), n * 2)):
        m = color_re.search(s)
        words = re.findall(r"[A-Za-z]{4,}", s)
        if m and rng.random() < 0.4:
            qs.append(rng.choice([
                f"What color is the {m.group(2)}?",
                f"What is the {m.group(1)} object?",
                f"Where is the {m.group(2)}?",
            ]))
        elif len(words) >= 3 and rng.random() < 0.45:
            # multi-term questions: the benchmark's style carries 3-6
            # content words ("the title of the document being filled out
            # on the lab bench"), which is what IDF-overlap scoring —
            # and any model distilling it — keys on
            w1, w2 = (w.lower() for w in rng.sample(words, 2))
            qs.append(rng.choice([
                f"What is the {w1} next to the {w2}?",
                f"What {w1} is used with the {w2}?",
                f"What is shown on the {w1} near the {w2}?",
                f"What type of {w1} does the person use while "
                f"handling the {w2}?",
                f"What happens to the {w1} after the {w2} is used?",
            ]))
        elif words:
            w = rng.choice(words).lower()
            qs.append(rng.choice([
                f"What does the person do with the {w}?",
                f"When does the {w} appear?",
                f"What is near the {w}?",
                f"What equipment is the person using?",
            ]))
        if len(qs) >= n:
            break
    return qs


def answer_examples(qc_pairs: Sequence[Tuple[str, str]],
                    max_chars: int = 360) -> List[Example]:
    """(question, context) pairs -> answer-prompt examples with the
    teacher's extractive answer (capped so responses fit the serve-time
    decode budget)."""
    out: List[Example] = []
    for q, ctx in qc_pairs:
        prompt = build_benchmark_answer_prompt(q, ctx)
        resp = extractive_answer(q, ctx, max_chars=max_chars)
        out.append(("answer", prompt, resp))
    return out


def synthetic_answer_pairs(sents: Sequence[str], rng: random.Random,
                           n: int) -> List[Tuple[str, str]]:
    """Unlimited (question, context) pairs: 3-6 chunk texts (synthetic +
    corpus sentences, some with Time:/Content: scaffolding like stored
    splitter chunks) in the retriever's output format, with a question
    grounded in one of them."""
    pairs: List[Tuple[str, str]] = []
    for _ in range(n):
        if rng.random() < 0.06:       # retrieval misses happen at serve
            q = synth_questions([synth_sentence(rng)], rng, 1)
            if q:
                pairs.append((q[0],
                              f"No results found for query '{q[0]}'"))
            continue
        k = rng.randint(3, 6)
        chunk_texts = []
        for j in range(k):
            parts = [synth_sentence(rng) if rng.random() < 0.7
                     else rng.choice(list(sents))
                     for _ in range(rng.randint(1, 3))]
            text = " ".join(parts)
            if rng.random() < 0.5:      # splitter-chunk scaffolding
                m, s = rng.randrange(18), rng.randrange(0, 56, 5)
                text = f"Time: {m:02d}:{s:02d}-{m:02d}:{s + 4:02d}\n" \
                       f"Content: {text}"
            chunk_texts.append(text)
        target = rng.choice(chunk_texts)
        qs = synth_questions(sentences_of([target]) or [target], rng, 1)
        if not qs:
            continue
        times = [f"{rng.randrange(18):02d}:{rng.randrange(60):02d}-"
                 f"{rng.randrange(18):02d}:{rng.randrange(60):02d}"
                 for _ in chunk_texts]
        pairs.append((qs[0], format_context(chunk_texts, qs[0],
                                            times=times)))
    return pairs


def copy_examples(sents: Sequence[str], rng: random.Random,
                  n: int) -> List[Example]:
    out: List[Example] = []
    for _ in range(n):
        k = rng.randint(1, 3)
        text = " ".join(rng.sample(list(sents), min(k, len(sents))))[:340]
        prompt = f"Repeat the text below exactly.\nTEXT:\n{text}\nCOPY:\n"
        out.append(("copy", prompt, text))
    return out


def real_retrieval_pairs(captions, rng: random.Random, n_questions: int
                         ) -> List[Tuple[str, str]]:
    """(question, context) pairs through the REAL hybrid retriever over a
    graph whose chunks match the SERVE-time distribution: token-splitter
    chunks of the KG builder's ``Time:/Content:`` batch aggregation at the
    eval chunk sizes (140/14 sweep-best + 296/16 parity), mixed with
    whole captions (the realtime engine's chunk unit).  Shared by
    scripts/train_instruct_lm.py and scripts/train_answer_selector.py."""
    import asyncio

    from ..core.config import RetrievalConfig
    from ..graph.embedded import EmbeddedGraphStore
    from ..pipeline.pre_injector import PreLLMInjector
    from ..pipeline.prompts import build_pre_llm_prompt
    from ..pipeline.retriever_hybrid import HybridRetriever
    from ..pipeline.text_splitter import TokenTextSplitter
    from ..services.embed_client import make_embed_client
    from ..services.rerank_client import make_rerank_client

    embed = make_embed_client("tpu", dim=512)
    rerank = make_rerank_client("tpu", embed_client=embed)
    store = EmbeddedGraphStore("instruct", persist_dir=None, persist=False)
    teacher = LocalChatClient()

    # serve-distribution doc units
    docs: List[str] = []
    for size, overlap in ((140, 14), (296, 16)):
        splitter = TokenTextSplitter(chunk_size=size, chunk_overlap=overlap)
        for b_start in range(0, len(captions), 3):
            items = captions[b_start:b_start + 3]
            text = "\n".join(
                f"Time: {((b_start + i) * 5) // 60:02d}:"
                f"{((b_start + i) * 5) % 60:02d}-"
                f"{((b_start + i) * 5 + 4) // 60:02d}:"
                f"{((b_start + i) * 5 + 4) % 60:02d}\nContent: {c}"
                for i, c in enumerate(items))
            docs.extend(splitter.split_text(text))
    docs.extend(captions)                     # realtime-engine chunk unit
    docs = list(dict.fromkeys(docs))

    embs = embed.embed(docs)
    batch = [{"time": "00:00-00:04", "content": "train"}]
    for b_start in range(0, len(docs), 6):
        chunks, triplets = [], []
        for i in range(b_start, min(b_start + 6, len(docs))):
            cid = f"tr_{i // 3}_{i % 3}"
            chunks.append({"id": cid, "content": docs[i],
                           "index": i % 3,
                           "embedding": [float(x) for x in embs[i]],
                           "time": f"{(i * 5) // 60:02d}:{(i * 5) % 60:02d}-"
                                   f"{(i * 5 + 4) // 60:02d}:"
                                   f"{(i * 5 + 4) % 60:02d}"})
            raw = teacher.complete_sync(
                build_pre_llm_prompt(docs[i], 6))
            for tr in PreLLMInjector.parse_pipe_delimited(raw, cid):
                tr["source_chunks"] = [cid]
                triplets.append(tr)
        store.add_batch_to_graph(triplets, batch, b_start // 6,
                                 text_chunks=chunks)

    profiles = [
        RetrievalConfig(top_k_chunks=3, post_compression=True,
                        entity_first=True),
        RetrievalConfig(top_k_chunks=5, post_compression=False,
                        entity_first=False),
    ]
    sents = sentences_of(captions)
    questions = synth_questions(sents, rng, n_questions)

    async def run():
        pairs = []
        for prof in profiles:
            retriever = HybridRetriever(prof, store, embed, rerank,
                                        output_file=None)
            for q in questions:
                ctx, _ = await retriever.perform_hybrid_retrieval(q)
                pairs.append((q, ctx))
        return pairs

    return asyncio.run(run())


def build_dataset(captions: Sequence[str], rng: random.Random,
                  n_pre: int = 3000, n_instr: int = 600,
                  n_consol: int = 400, n_copy: int = 600,
                  n_synth_answers: int = 0,
                  qc_pairs: Optional[Sequence[Tuple[str, str]]] = None,
                  ) -> List[Example]:
    chunks = make_chunks(captions, rng, min_total=n_pre)
    sents = sentences_of(captions) + [synth_sentence(rng)
                                      for _ in range(1500)]
    data: List[Example] = []
    data += pre_llm_examples(chunks, rng, n_pre)
    data += instruction_examples(chunks, rng, n_instr)
    data += consolidate_examples(chunks, rng, n_consol)
    data += copy_examples(sents, rng, n_copy)
    if n_synth_answers:
        data += answer_examples(
            synthetic_answer_pairs(sents, rng, n_synth_answers))
    if qc_pairs:
        data += answer_examples(qc_pairs)
    rng.shuffle(data)
    return data
