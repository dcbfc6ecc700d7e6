"""Final LLM consolidation (fallback path when global refinement is off).

Parity with reference src/components/llm_injector.py:23-240: one
consolidation call over the pre-extracted triplets with a failure ladder —
structured JSON ask -> raw "JSON only" re-ask with regex extraction ->
return the pre-extracted triplets unchanged; ``max_tokens`` is budgeted
dynamically from the prompt size against an assumed 8192-token context;
prompts and responses are appended to the per-batch trace file.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ..core.config import LLMInjectorConfig
from ..core.logger import get_logger
from .prompts import build_injector_prompt
from .refiner import parse_json_object

logger = get_logger("llm_injector")

_ASSUMED_CONTEXT = 8192
_WORDS_TO_TOKENS = 1.3


class LLMInjector:
    def __init__(self, config: LLMInjectorConfig, chat_client,
                 max_new_triplets: int = 15) -> None:
        self.config = config
        self.chat = chat_client
        self.max_new_triplets = max_new_triplets
        self.trace_file: Optional[str] = None

    def _trace(self, label: str, text: str) -> None:
        if not self.trace_file:
            return
        try:
            with open(self.trace_file, "a", encoding="utf-8") as f:
                f.write(f"\n===== {label} =====\n{text}\n")
        except OSError:
            pass

    def _safe_max_tokens(self, prompt: str) -> int:
        prompt_tokens = int(len(prompt.split()) * _WORDS_TO_TOKENS)
        budget = _ASSUMED_CONTEXT - prompt_tokens - 64
        return max(256, min(self.config.max_tokens, budget))

    @staticmethod
    def _to_triplet_dicts(items: List[Any]) -> List[Dict[str, Any]]:
        out = []
        for item in items:
            if isinstance(item, dict):
                if item.get("head") and item.get("relation") \
                        and item.get("tail"):
                    out.append({
                        "head": item["head"], "relation": item["relation"],
                        "tail": item["tail"],
                        "source_chunks": item.get("source_chunks", [])})
            elif isinstance(item, (list, tuple)) and len(item) >= 3:
                sources = item[3] if len(item) > 3 and \
                    isinstance(item[3], list) else []
                out.append({"head": item[0], "relation": item[1],
                            "tail": item[2], "source_chunks": sources})
        return out

    async def extract_triplets(self, pre_extracted: List[Dict[str, Any]],
                               network_info: str = "",
                               ) -> List[Dict[str, Any]]:
        if not pre_extracted:
            return []
        prompt = build_injector_prompt(json.dumps(pre_extracted),
                                       network_info or
                                       "No graph context available",
                                       self.max_new_triplets)
        self._trace("INJECTOR PROMPT", prompt)
        max_tokens = self._safe_max_tokens(prompt)

        # rung 1: structured ask
        try:
            raw = await self.chat.complete(prompt,
                                           temperature=self.config.temperature,
                                           max_tokens=max_tokens)
            self._trace("INJECTOR RESPONSE", raw)
            data = parse_json_object(raw)
            if data and isinstance(data.get("triplets"), list):
                out = self._to_triplet_dicts(data["triplets"])
                if out:
                    return out
        except Exception as e:
            logger.warning("Structured consolidation failed: %s", e)

        # rung 2: raw JSON-only re-ask
        try:
            retry_prompt = (prompt +
                            "\nRespond with ONLY the JSON object, no prose.")
            raw = await self.chat.complete(retry_prompt, temperature=0.0,
                                           max_tokens=max_tokens)
            self._trace("INJECTOR RETRY RESPONSE", raw)
            data = parse_json_object(raw)
            if data and isinstance(data.get("triplets"), list):
                out = self._to_triplet_dicts(data["triplets"])
                if out:
                    return out
        except Exception as e:
            logger.warning("Raw-JSON consolidation failed: %s", e)

        # rung 3: pass through the pre-extracted triplets
        logger.info("Consolidation fell back to pre-extracted triplets "
                    "(%d)", len(pre_extracted))
        self._trace("INJECTOR FALLBACK", "returned pre-extracted triplets")
        return pre_extracted
