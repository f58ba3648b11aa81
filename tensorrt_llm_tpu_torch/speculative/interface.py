"""Speculative decoding interfaces.

Port of ``tensorrt_llm_tpu/speculative/interface.py``, unchanged: the
mode taxonomy and the Drafter contract (reference:
tensorrt_llm/_torch/speculative/interface.py:205 SpeculativeDecodingMode,
drafter.py:12 Drafter.prepare_draft_tokens called from the executor loop
py_executor.py:2671). Host drafters (NGram, suffix automaton, a user's
drafter, the two-model drafter) fill ``request.draft_tokens`` on the sync
scheduler and the target verifies them in one step; the EAGLE3 head of
the fused device window (runtime/spec_window.py) proposes on the device
and never calls ``prepare_draft_tokens``.
"""
from __future__ import annotations

from enum import Enum
from typing import List, Optional, Sequence

from ..runtime.request import LlmRequest


class SpeculativeDecodingMode(str, Enum):
    NONE = "NONE"
    DRAFT_TARGET = "DRAFT_TARGET"
    NGRAM = "NGRAM"
    EAGLE3 = "EAGLE3"
    MTP = "MTP"
    SUFFIX_AUTOMATON = "SA"
    USER_PROVIDED = "USER_PROVIDED"


class Drafter:
    """Produces draft tokens for scheduled generation requests."""

    def __init__(self, max_draft_len: int):
        self.max_draft_len = max_draft_len

    def prepare_draft_tokens(self, requests: Sequence[LlmRequest]) -> None:
        """Fill ``request.draft_tokens`` in place for each request."""
        raise NotImplementedError

    def update(self, request: LlmRequest, accepted: List[int]) -> None:
        """Observe accepted tokens (for adaptive drafters)."""


class SpeculationGate:
    """Auto-disable speculation above a concurrency threshold
    (reference: speculative/speculation_gate.py)."""

    def __init__(self, max_concurrency: Optional[int] = None):
        self.max_concurrency = max_concurrency

    def enabled(self, num_active: int) -> bool:
        return (self.max_concurrency is None or
                num_active <= self.max_concurrency)
