"""Benchmark evaluation: retrieval results -> accuracy statistics.

Parity with reference src/pipeline/benchmark.py:45-272: per result, an LLM
generates an answer from the retrieved context, then an LLM judge returns
``{"is_correct": bool}`` (with a "true"-substring fallback on parse
failure); items without groundtruth are skipped; output is
``{"statistics": {total_queries, correct_answers, incorrect_answers,
skipped_answers, accuracy}, "results": [...]}``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

from ..core.config import PipelineConfig
from ..core.logger import get_logger
from ..services.llm_client import make_chat_client
from .prompts import (build_benchmark_answer_prompt,
                      build_benchmark_evaluation_prompt)
from .refiner import parse_json_object

logger = get_logger("benchmark")

_CONTEXT_SUMMARY_CHARS = 300


class BenchmarkEvaluator:
    def __init__(self, config: PipelineConfig, chat_client=None,
                 judge_client=None) -> None:
        self.config = config
        b = config.benchmark_llm
        self.chat = chat_client or make_chat_client(
            config.backend.llm, endpoint=b.endpoint, model=b.model_name,
            api_key=b.api_key,
            checkpoint_path=config.llm_injector.checkpoint_path,
            answer_selector_path=config.llm_injector.answer_selector_path,
            answer_selector_mode=config.llm_injector.answer_selector_mode)
        # benchmark_llm.judge_backend pins the judging client separately
        # from answer generation ("" = same client)
        if judge_client is not None:
            self.judge = judge_client
        elif b.judge_backend and b.judge_backend != config.backend.llm:
            self.judge = make_chat_client(
                b.judge_backend, endpoint=b.endpoint, model=b.model_name,
                api_key=b.api_key,
                checkpoint_path=config.llm_injector.checkpoint_path)
        else:
            self.judge = self.chat

    async def evaluate_retrieval_results(self, results_path: str,
                                         output_path: str) -> Dict[str, Any]:
        with open(results_path) as f:
            results = json.load(f)
        stats = {"total_queries": len(results), "correct_answers": 0,
                 "incorrect_answers": 0, "skipped_answers": 0}
        detailed: List[Dict[str, Any]] = []
        for i, item in enumerate(results):
            query = item.get("query", "")
            groundtruth = item.get("groundtruth", "")
            context = item.get("retrieval", "")
            if not groundtruth:
                stats["skipped_answers"] += 1
                detailed.append({**self._record(item, "", None),
                                 "skipped": True})
                continue
            answer = await self._generate_answer(query, context)
            is_correct = await self._evaluate_answer(query, groundtruth,
                                                     answer, context)
            if is_correct:
                stats["correct_answers"] += 1
            else:
                stats["incorrect_answers"] += 1
            detailed.append(self._record(item, answer, is_correct))
            logger.info("[%d/%d] %s -> %s", i + 1, len(results),
                        query[:60], "CORRECT" if is_correct else "WRONG")
        graded = stats["correct_answers"] + stats["incorrect_answers"]
        stats["accuracy"] = (stats["correct_answers"] / graded
                             if graded else 0.0)
        out = {"statistics": stats, "results": detailed}
        p = Path(output_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(out, indent=2, ensure_ascii=False))
        logger.info("Benchmark accuracy: %.2f%% (%d/%d)",
                    stats["accuracy"] * 100, stats["correct_answers"],
                    graded)
        return out

    @staticmethod
    def _record(item: Dict, answer: str, is_correct: Optional[bool]
                ) -> Dict[str, Any]:
        context = item.get("retrieval", "")
        summary = context[:_CONTEXT_SUMMARY_CHARS]
        if len(context) > _CONTEXT_SUMMARY_CHARS:
            summary += "..."
        return {
            "query": item.get("query", ""),
            "groundtruth": item.get("groundtruth", ""),
            "retrieved_answer": answer,
            "context_summary": summary,
            "is_correct": is_correct,
        }

    async def _generate_answer(self, query: str, context: str) -> str:
        prompt = build_benchmark_answer_prompt(query, context)
        try:
            b = self.config.benchmark_llm
            return (await self.chat.complete(
                prompt, temperature=b.temperature,
                max_tokens=b.max_tokens)).strip()
        except Exception as e:
            logger.error("Answer generation failed: %s", e)
            return ""

    async def _evaluate_answer(self, query: str, groundtruth: str,
                               answer: str, context: str) -> bool:
        prompt = build_benchmark_evaluation_prompt(query, groundtruth,
                                                   answer, context)
        try:
            raw = await self.judge.complete(prompt, temperature=0.0,
                                            max_tokens=128)
            data = parse_json_object(raw)
            if data is not None and "is_correct" in data:
                return bool(data["is_correct"])
            # fallback: "true" substring, as in the reference
            return "true" in raw.lower()
        except Exception as e:
            logger.error("Judge failed: %s", e)
            return False
