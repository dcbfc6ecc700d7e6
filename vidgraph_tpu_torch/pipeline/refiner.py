"""Global refinement: one LLM pass consolidating the batch's triplets.

Two modes, parity with reference src/components/global_refiner.py:43-460:

* legacy ``refine_triplets`` — asks for ``{"triplets": [[h, r, t, [src]]]}``,
  restores missing source_chunks by exact match then SequenceMatcher >= 0.7
  fuzzy backtracking, and falls back to dedupe-only on any error;
* ``refine_triplets_instruction_based`` — with subgraph context, asks for 4
  operation lists (new_triplets / inter_chunk_relations /
  merge_instructions / prune_instructions), parses JSON out of raw text
  (direct parse, then first ``{...}`` block), converts source chunk ids to
  the short ``batch_chunk`` form in the prompt, and force-empties the
  context-dependent op lists when the context was empty (hallucination
  guard).

Refinement LLM runs at temperature 0.0.
"""
from __future__ import annotations

import json
import re
import time
from difflib import SequenceMatcher
from typing import Any, Dict, List, Optional

from ..core.config import ChunkingConfig
from ..core.logger import get_logger
from .pre_injector import get_short_chunk_id
from .prompts import build_injector_prompt, build_instruction_prompt

logger = get_logger("global_refiner")


def parse_json_object(text: str) -> Optional[Dict[str, Any]]:
    """Direct JSON parse, else first {...} block in the text."""
    try:
        return json.loads(text.strip())
    except (json.JSONDecodeError, AttributeError):
        pass
    m = re.search(r"\{[\s\S]*\}", text or "")
    if m:
        try:
            return json.loads(m.group(0))
        except json.JSONDecodeError:
            return None
    return None


def _triplet_key(tr: Dict[str, Any]) -> str:
    return (f"{str(tr.get('head', '')).lower()}|"
            f"{str(tr.get('relation', '')).lower()}|"
            f"{str(tr.get('tail', '')).lower()}")


# words so generic that grounding on them carries no signal
_GROUND_SKIP = frozenset(
    "a an the and or of to in on at is are was were this that with for "
    "from by as it its his her their then there here".split())


def entity_grounded(name: Any, text_low: str) -> bool:
    """True iff every content token of ``name`` occurs whole-word in the
    (lower-cased) batch text.  'Blue Nitrile Gloves' grounds in a batch
    that mentions blue nitrile gloves; 'Pink Gloves' does not unless the
    text says pink."""
    toks = [t for t in re.findall(r"[a-z0-9]+", str(name).lower())
            if t not in _GROUND_SKIP]

    def _tok_ok(t: str) -> bool:
        # light morphology: pre-extraction canonicalises plurals/inflections
        # ("Beaker" from a text that only says "beakers"), so accept
        # whole-word matches of simple variants too
        variants = {t, t + "s", t + "es", t + "ing", t + "ed"}
        if len(t) > 4 and t.endswith("s"):
            variants.add(t[:-1])
        if len(t) > 4 and t.endswith("e"):
            variants.update((t[:-1] + "ing", t + "d"))
        return any(re.search(r"\b" + re.escape(v) + r"\b", text_low)
                   for v in variants)

    return bool(toks) and all(_tok_ok(t) for t in toks)


def _pair_key(h: Any, t: Any) -> str:
    return f"{str(h).lower().strip()}|{str(t).lower().strip()}"


def _ground_new_triplets(new_triplets: List[Any],
                         candidates: List[Dict[str, Any]],
                         grounding_text: str,
                         lm_cap: int) -> (List[Any], Dict[str, int]):
    """Filter the LLM's new_triplets to text-grounded ones (capped at
    ``lm_cap``) and append the grounded deduplicated candidates whose
    (head, tail) pair the LLM did not re-emit.  Returns (triplets, stats)
    with triplets in op-list form [head, relation, tail, sources]."""
    text_low = grounding_text.lower()
    kept: List[Any] = []
    covered = set()
    dropped = 0
    for item in new_triplets:
        if not isinstance(item, (list, tuple)) or len(item) < 3:
            dropped += 1
            continue
        if len(kept) >= lm_cap:
            break
        if entity_grounded(item[0], text_low) and \
                entity_grounded(item[2], text_low):
            kept.append(list(item))
            covered.add(_pair_key(item[0], item[2]))
        else:
            dropped += 1
    restored = 0
    for cand in candidates:
        h, t = cand.get("head", ""), cand.get("tail", "")
        if _pair_key(h, t) in covered:
            continue
        if not (entity_grounded(h, text_low)
                and entity_grounded(t, text_low)):
            continue
        kept.append([h, cand.get("relation", ""), t,
                     cand.get("source_chunks", [])])
        restored += 1
    return kept, {"lm_kept": len(kept) - restored, "lm_dropped": dropped,
                  "restored": restored}


class GlobalRefiner:
    def __init__(self, chunking_config: ChunkingConfig, chat_client) -> None:
        self.config = chunking_config
        self.chat = chat_client

    # --------------------------------------------------------------- legacy
    async def refine_triplets(self, triplets: List[Dict[str, Any]],
                              network_info: str = "",
                              global_limit: int = 25,
                              ) -> List[Dict[str, Any]]:
        if not triplets:
            return []
        capped = triplets[:global_limit]
        try:
            prompt = build_injector_prompt(
                json.dumps(capped), network_info or
                "No graph context available",
                self.config.max_new_triplets or global_limit)
            t0 = time.perf_counter()
            raw = await self.chat.complete(
                prompt, temperature=0.0,
                max_tokens=self.config.refinement_max_tokens)
            logger.debug("Refinement LLM call took %.2fs",
                         time.perf_counter() - t0)
            data = parse_json_object(raw)
            if data is None or "triplets" not in data:
                raise ValueError("no triplets JSON in refinement output")
            refined = []
            for item in data["triplets"]:
                if isinstance(item, (list, tuple)) and len(item) == 4:
                    refined.append({
                        "head": item[0], "relation": item[1],
                        "tail": item[2],
                        "source_chunks": (item[3] if isinstance(item[3], list)
                                          else [item[3]]),
                    })
            for tr in refined:
                if not tr.get("source_chunks"):
                    tr["source_chunks"] = self._backtrack_chunk_indices(
                        tr, capped)
                else:
                    tr["source_chunks"] = sorted(set(tr["source_chunks"]),
                                                 key=str)
            logger.info("Refinement: %d -> %d triplets", len(capped),
                        len(refined))
            return refined
        except Exception as e:
            logger.error("Global refinement failed: %s — falling back to "
                         "dedupe", e)
            return self._deduplicate(capped)

    def _backtrack_chunk_indices(self, refined: Dict[str, Any],
                                 originals: List[Dict[str, Any]]) -> List:
        rkey = _triplet_key(refined)
        for orig in originals:
            if _triplet_key(orig) == rkey:
                return orig.get("source_chunks", [])
        best, best_ratio = [], 0.0
        for orig in originals:
            ratio = SequenceMatcher(None, rkey, _triplet_key(orig)).ratio()
            if ratio > best_ratio:
                best_ratio = ratio
                best = orig.get("source_chunks", [])
        if best_ratio > 0.7:
            return best
        logger.warning("Could not backtrack triplet to sources: %s", refined)
        return []

    @staticmethod
    def _deduplicate(triplets: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        seen: Dict[str, Dict[str, Any]] = {}
        out = []
        for tr in triplets:
            key = _triplet_key(tr)
            if "||" in key or key.startswith("|") or key.endswith("|"):
                continue
            sources = tr.get("source_chunks", [])
            if not isinstance(sources, list):
                sources = [sources] if sources else []
            if key not in seen:
                entry = {"head": tr.get("head", ""),
                         "relation": tr.get("relation", ""),
                         "tail": tr.get("tail", ""),
                         "source_chunks": sorted(set(sources), key=str)}
                seen[key] = entry
                out.append(entry)
            else:
                seen[key]["source_chunks"] = sorted(
                    set(seen[key]["source_chunks"]) | set(sources), key=str)
        return out

    # -------------------------------------------------------- instruction mode
    async def refine_triplets_instruction_based(
            self, triplets: List[Dict[str, Any]],
            subgraphs: Optional[Dict[str, str]] = None,
            global_limit: int = 25,
            grounding_text: str = "",
    ) -> Dict[str, Any]:
        """Returns the parsed 4-op dict (possibly sanitised).

        When ``grounding_text`` (the batch's raw caption text) is given,
        the LLM's ``new_triplets`` are treated as an EDIT SUGGESTION, not
        a wholesale replacement (round 5): a triplet survives only if every
        content token of its head and tail appears in the batch text
        (whole-word), and pre-extracted candidates the LLM dropped are
        restored (grounded ones only).  A small on-device LM can emit
        fluent-but-ungrounded triplets ("Pink Gloves" over a batch that
        only ever shows blue nitrile gloves); without this the round-5
        instruct LM collapsed the 215-chunk graph from ~600 real entities
        to 269 partly-hallucinated ones and accuracy to 6/30.  The
        deterministic teacher's outputs are grounded by construction, so
        this is a no-op on the `backend.llm: local` path (verified by the
        unchanged accuracy matrix)."""
        empty_ops = {"new_triplets": [], "inter_chunk_relations": [],
                     "merge_instructions": [], "prune_instructions": []}
        if not triplets:
            return empty_ops
        capped = triplets[:global_limit]

        context_is_empty = not subgraphs
        if subgraphs:
            subgraph_context = "\n".join(
                f"Subgraph_{i + 1}: {s}"
                for i, s in enumerate(list(subgraphs.values())[:5]))
        else:
            subgraph_context = ("No subgraph context available\n"
                                "No existing entities or relations.")

        processed = []
        for tr in capped:
            p = dict(tr)
            if p.get("source_chunks"):
                p["source_chunks"] = [
                    get_short_chunk_id(c) if isinstance(c, str) else c
                    for c in p["source_chunks"]]
            processed.append(p)

        prompt = build_instruction_prompt(
            json.dumps(processed), subgraph_context,
            self.config.max_new_triplets,
            self.config.max_inter_chunk_relations,
            self.config.max_merge_instructions,
            self.config.max_prune_instructions,
            context_is_empty=context_is_empty)
        try:
            t0 = time.perf_counter()
            raw = await self.chat.complete(
                prompt, temperature=0.0,
                max_tokens=self.config.refinement_max_tokens)
            logger.info("Instruction refinement LLM call: %.2fs "
                        "(prompt %dB)", time.perf_counter() - t0,
                        len(prompt))
        except Exception as e:
            logger.error("Instruction refinement LLM failed: %s", e)
            return {**empty_ops,
                    "new_triplets": [[t.get("head"), t.get("relation"),
                                      t.get("tail"),
                                      t.get("source_chunks", [])]
                                     for t in self._deduplicate(capped)]}
        data = parse_json_object(raw)
        if data is None:
            # Unparseable (e.g. truncated) LLM output must degrade like the
            # legacy mode — keep the deduped pre-extracted triplets instead
            # of silently dropping the whole batch (reference ladder:
            # src/components/global_refiner.py:198-233).
            logger.error("Instruction refinement output unparseable — "
                         "falling back to deduped candidates")
            return {**empty_ops,
                    "new_triplets": [[t.get("head"), t.get("relation"),
                                      t.get("tail"),
                                      t.get("source_chunks", [])]
                                     for t in self._deduplicate(capped)]}
        ops = {k: data.get(k, []) or [] for k in empty_ops}
        if context_is_empty:
            for k in ("inter_chunk_relations", "merge_instructions",
                      "prune_instructions"):
                if ops[k]:
                    logger.warning("Hallucination guard: forcing %s "
                                   "(%d items) to [] on empty context",
                                   k, len(ops[k]))
                    ops[k] = []
        # grounding guard (round 5): see docstring.  The guard applies the
        # max_new_triplets cap to the surviving LLM triplets itself; the
        # restored candidates are uncapped, mirroring the unparseable-
        # output fallback above (which returns ALL deduped candidates).
        if grounding_text:
            ops["new_triplets"], stats = _ground_new_triplets(
                ops["new_triplets"], self._deduplicate(capped),
                grounding_text, self.config.max_new_triplets)
            if stats["lm_dropped"] or stats["restored"]:
                logger.info(
                    "Grounding guard: kept %d LLM triplets, dropped %d "
                    "ungrounded, restored %d candidates",
                    stats["lm_kept"], stats["lm_dropped"],
                    stats["restored"])
        else:
            ops["new_triplets"] = ops["new_triplets"][
                :self.config.max_new_triplets]
        ops["inter_chunk_relations"] = ops["inter_chunk_relations"][
            :self.config.max_inter_chunk_relations]
        ops["merge_instructions"] = ops["merge_instructions"][
            :self.config.max_merge_instructions]
        ops["prune_instructions"] = ops["prune_instructions"][
            :self.config.max_prune_instructions]
        return ops

    @staticmethod
    def ops_to_triplets(ops: Dict[str, Any], originals: List[Dict[str, Any]]
                        ) -> List[Dict[str, Any]]:
        """Convert new_triplets op list into triplet dicts, restoring full
        source-chunk ids from the originals where the short form matches."""
        short_to_full: Dict[str, str] = {}
        for tr in originals:
            for c in tr.get("source_chunks", []):
                if isinstance(c, str):
                    short_to_full[get_short_chunk_id(c)] = c
        out = []
        for item in ops.get("new_triplets", []):
            if not isinstance(item, (list, tuple)) or len(item) < 3:
                continue
            sources = item[3] if len(item) > 3 and isinstance(item[3], list) \
                else []
            restored = [short_to_full.get(str(s), s) for s in sources]
            out.append({"head": item[0], "relation": item[1],
                        "tail": item[2], "source_chunks": restored})
        return out
