"""Request scheduling: capacity admission + micro-batch/chunking.

Port of ``tensorrt_llm_tpu/runtime/scheduler.py``, unchanged (pure host
code). Policies:

  * CapacityScheduler: ``GUARANTEED_NO_EVICT`` (admit only if the request
    can run to completion without evicting anyone, capacityScheduler.h:109),
    ``MAX_UTILIZATION`` (admit while one more iteration fits; pause
    most-recently-started requests on pressure, capacityScheduler.h:91),
    ``STATIC_BATCH`` (capacityScheduler.h:133).
  * MicroBatchScheduler: packs context chunks + generation tokens into a
    ``max_num_tokens`` budget with chunking policies ``FIRST_COME_FIRST_SERVED``
    and ``EQUAL_PROGRESS`` (scheduler.py:338,667,729).

The token budget doubles as the largest token bucket: every scheduled
batch is later padded up to a bucket (model_engine._pick_bucket).
"""
from __future__ import annotations

import dataclasses
from enum import Enum
from typing import List, Optional, Sequence, Tuple

from .kv_cache_manager import KVCacheManager
from .request import LlmRequest, LlmRequestState


class CapacitySchedulerPolicy(str, Enum):
    """Reference: llm_args.py SchedulerConfig / capacityScheduler.h."""
    GUARANTEED_NO_EVICT = "guaranteed_no_evict"
    MAX_UTILIZATION = "max_utilization"
    STATIC_BATCH = "static_batch"


class ContextChunkingPolicy(str, Enum):
    """Reference: scheduler.py:338."""
    FIRST_COME_FIRST_SERVED = "first_come_first_served"
    EQUAL_PROGRESS = "equal_progress"


@dataclasses.dataclass
class ScheduledRequests:
    """Output of one scheduling pass (reference: scheduler.py ScheduledRequests)."""
    context_requests: List[LlmRequest] = dataclasses.field(default_factory=list)
    generation_requests: List[LlmRequest] = dataclasses.field(default_factory=list)
    paused_requests: List[LlmRequest] = dataclasses.field(default_factory=list)

    @property
    def all_requests(self) -> List[LlmRequest]:
        return self.context_requests + self.generation_requests

    @property
    def batch_size(self) -> int:
        return len(self.context_requests) + len(self.generation_requests)

    @property
    def is_empty(self) -> bool:
        return self.batch_size == 0


class CapacityScheduler:
    """Selects which active requests may run this iteration given KV memory."""

    def __init__(self,
                 max_num_requests: int,
                 kv_cache_manager: Optional[KVCacheManager],
                 policy: CapacitySchedulerPolicy = CapacitySchedulerPolicy.GUARANTEED_NO_EVICT):
        self.max_num_requests = max_num_requests
        self.kv_cache_manager = kv_cache_manager
        self.policy = policy

    def schedule(self, active_requests: Sequence[LlmRequest]
                 ) -> Tuple[List[LlmRequest], List[LlmRequest]]:
        """Returns (fitting_requests, paused_requests).

        ``active_requests`` arrive in arrival order; generation-phase
        requests take priority over new context requests (in-flight batching
        invariant, trtGptModelInflightBatching semantics).
        """
        if self.kv_cache_manager is None or \
                self.policy == CapacitySchedulerPolicy.STATIC_BATCH:
            return self._schedule_static(active_requests)
        if self.policy == CapacitySchedulerPolicy.GUARANTEED_NO_EVICT:
            return self._schedule_no_evict(active_requests)
        return self._schedule_max_util(active_requests)

    # ------------------------------------------------------------------ #
    def _schedule_static(self, active: Sequence[LlmRequest]):
        fitting = [r for r in active if not r.is_finished][:self.max_num_requests]
        return fitting, []

    def _schedule_no_evict(self, active: Sequence[LlmRequest]):
        kv = self.kv_cache_manager
        free = kv.get_num_free_blocks()
        fitting: List[LlmRequest] = []
        fitting_ids = set()
        # pass 1: already-running requests (generation or mid-context) are
        # guaranteed to fit by the admission-time reservation.
        reserved = 0
        for req in active:
            if req.is_finished:
                continue
            if req.request_id in kv._seq_blocks:
                if len(fitting) < self.max_num_requests:
                    fitting.append(req)
                    fitting_ids.add(req.request_id)
                    reserved += kv.get_remaining_blocks_to_completion(req)
        # pass 2: admit new context requests whose full completion fits.
        for req in active:
            if req.is_finished or req.request_id in fitting_ids:
                continue
            if len(fitting) >= self.max_num_requests:
                break
            need = kv.get_remaining_blocks_to_completion(req)
            if reserved + need <= free:
                fitting.append(req)
                fitting_ids.add(req.request_id)
                reserved += need
        return fitting, []

    def _schedule_max_util(self, active: Sequence[LlmRequest]):
        kv = self.kv_cache_manager
        free = kv.get_num_free_blocks()
        fitting: List[LlmRequest] = []
        paused: List[LlmRequest] = []
        need_total = 0
        candidates = [r for r in active if not r.is_finished]
        for req in candidates:
            one_step = kv.get_needed_blocks_one_step(req)
            if len(fitting) < self.max_num_requests and need_total + one_step <= free:
                fitting.append(req)
                need_total += one_step
            else:
                # pause (possible eviction) — newest started first is already
                # the iteration order here since we walk arrival order and
                # pause the tail.
                if req.request_id in kv._seq_blocks:
                    paused.append(req)
        return fitting, paused


class MicroBatchScheduler:
    """Packs fitting requests into one forward pass under a token budget."""

    def __init__(self,
                 max_batch_size: int,
                 max_num_tokens: int,
                 enable_chunked_prefill: bool = True,
                 chunking_policy: ContextChunkingPolicy = ContextChunkingPolicy.FIRST_COME_FIRST_SERVED,
                 chunk_unit_size: Optional[int] = None):
        self.max_batch_size = max_batch_size
        self.max_num_tokens = max_num_tokens
        self.enable_chunked_prefill = enable_chunked_prefill
        self.chunking_policy = chunking_policy
        # chunk sizes snap to multiples of the KV page size so chunk
        # boundaries align with pages (reference: scheduler.py:640-805)
        self.chunk_unit_size = chunk_unit_size or 64

    def schedule(self, fitting: Sequence[LlmRequest]) -> ScheduledRequests:
        out = ScheduledRequests()
        budget = self.max_num_tokens
        # generation requests first: 1 token each (+ draft tokens)
        for req in fitting:
            if out.batch_size >= self.max_batch_size:
                break
            if req.is_generation_in_progress:
                cost = 1 + len(req.draft_tokens)
                if cost > budget:
                    continue
                budget -= cost
                out.generation_requests.append(req)
        ctx = [r for r in fitting if r.is_context_init_state]
        if ctx and budget > 0:
            if self.chunking_policy == ContextChunkingPolicy.EQUAL_PROGRESS:
                self._chunk_equal_progress(ctx, budget, out)
            else:
                self._chunk_fcfs(ctx, budget, out)
        return out

    # ------------------------------------------------------------------ #
    def _chunk_fcfs(self, ctx: List[LlmRequest], budget: int,
                    out: ScheduledRequests) -> None:
        """Greedy FCFS chunking (reference: scheduler.py:729)."""
        for req in ctx:
            if out.batch_size >= self.max_batch_size or budget <= 0:
                break
            remaining = req.context_remaining_length
            if not self.enable_chunked_prefill and remaining > budget:
                continue
            chunk = min(remaining, budget)
            if chunk < remaining:
                # snap down to the chunk unit so page boundaries align
                chunk = (chunk // self.chunk_unit_size) * self.chunk_unit_size
                if chunk == 0:
                    continue
            req.context_chunk_size = chunk
            budget -= chunk
            out.context_requests.append(req)

    def _chunk_equal_progress(self, ctx: List[LlmRequest], budget: int,
                              out: ScheduledRequests) -> None:
        """Distribute the budget evenly across context requests
        (reference: scheduler.py:667)."""
        selected = []
        for req in ctx:
            if out.batch_size + len(selected) >= self.max_batch_size:
                break
            selected.append(req)
        if not selected:
            return
        remaining = {r.request_id: r.context_remaining_length for r in selected}
        share = {r.request_id: 0 for r in selected}
        left = budget
        # round-robin in chunk units until budget or all remaining satisfied
        progressing = True
        while left > 0 and progressing:
            progressing = False
            for r in selected:
                rid = r.request_id
                if share[rid] >= remaining[rid] or left <= 0:
                    continue
                step = min(self.chunk_unit_size, remaining[rid] - share[rid], left)
                share[rid] += step
                left -= step
                progressing = True
        for r in selected:
            chunk = share[r.request_id]
            if chunk <= 0:
                continue
            if chunk < r.context_remaining_length:
                if not self.enable_chunked_prefill:
                    continue
                chunk = (chunk // self.chunk_unit_size) * self.chunk_unit_size
                if chunk == 0:
                    continue
            r.context_chunk_size = chunk
            out.context_requests.append(r)


class RequestScheduler:
    """Facade combining capacity + micro-batch scheduling
    (reference: scheduler.py SimpleScheduler)."""

    def __init__(self, capacity: CapacityScheduler, micro: MicroBatchScheduler):
        self.capacity = capacity
        self.micro = micro

    def schedule(self, active_requests: Sequence[LlmRequest]) -> ScheduledRequests:
        fitting, paused = self.capacity.schedule(active_requests)
        out = self.micro.schedule(fitting)
        out.paused_requests = paused
        return out
