"""Prompt-lookup (NGram) drafter.

Port of ``tensorrt_llm_tpu/speculative/ngram.py``, a copy (this package
imports nothing of the JAX package). Behavioral reference:
tensorrt_llm/_torch/speculative/ngram.py:1-211 — match the longest
recent n-gram of the generated suffix against the prompt+output history
and propose the continuation as draft tokens.
Pure-host, no extra model; the big win for input-grounded tasks
(summarization, code edit) per the reference's AUTO heuristic
(speculative/auto_heuristic.py picks ngram at small batch).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from ..runtime.request import LlmRequest
from .interface import Drafter


class NGramDrafter(Drafter):
    def __init__(self, max_draft_len: int = 4,
                 max_matching_ngram_size: int = 4):
        super().__init__(max_draft_len)
        self.max_matching_ngram_size = max_matching_ngram_size
        # per-request ngram index: map ngram tuple -> continuation start pos
        self._index: Dict[int, Dict[tuple, int]] = {}

    def prepare_draft_tokens(self, requests: Sequence[LlmRequest]) -> None:
        for req in requests:
            req.draft_tokens = self._draft_for(req)

    def _draft_for(self, req: LlmRequest) -> List[int]:
        history = req.all_token_ids
        if len(history) < 2:
            return []
        for n in range(min(self.max_matching_ngram_size,
                           len(history) - 1), 0, -1):
            suffix = tuple(history[-n:])
            # search latest occurrence of suffix before the end
            pos = self._rfind(history, suffix, end=len(history) - n)
            if pos >= 0:
                start = pos + n
                draft = history[start:start + self.max_draft_len]
                if draft:
                    return list(draft)
        return []

    @staticmethod
    def _rfind(history: List[int], ngram: tuple, end: int) -> int:
        n = len(ngram)
        for i in range(end - n, -1, -1):
            if tuple(history[i:i + n]) == ngram:
                return i
        return -1

    def drop_request(self, request_id: int) -> None:
        self._index.pop(request_id, None)
