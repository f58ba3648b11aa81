"""Request state machine for the continuous-batching runtime.

Port of ``tensorrt_llm_tpu/runtime/request.py`` (``LlmRequest`` /
``LlmRequestState``), with the fields the JAX package sets on a request
from outside it (``prompt_logprobs_result``) declared here, and the beam
rows' marker ``is_beam_row``.
Holds prompt/output tokens, scheduling state (context progress for chunked
prefill), sampling params, and stop-criteria evaluation. Pure host object —
nothing here touches a device.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from enum import IntEnum
from typing import List, Optional, Sequence

from ..sampling_params import SamplingParams


class LlmRequestState(IntEnum):
    """Request life-cycle states (the JAX package's values; the
    disaggregated-serving states are not ported)."""
    ENCODER_INIT = 0
    CONTEXT_INIT = 1            # waiting for / running context (prefill) phase
    GENERATION_IN_PROGRESS = 2
    GENERATION_TO_COMPLETE = 3  # last token being produced this iteration
    GENERATION_COMPLETE = 4


class FinishReason(IntEnum):
    NOT_FINISHED = 0
    END_ID = 1
    STOP_WORDS = 2
    LENGTH = 3
    TIMED_OUT = 4
    CANCELLED = 5
    ERROR = 6


_request_id_counter = itertools.count()


def next_request_id() -> int:
    return next(_request_id_counter)


@dataclass
class PerfMetrics:
    arrival_time: float = 0.0
    first_scheduled_time: float = 0.0
    first_token_time: float = 0.0
    last_token_time: float = 0.0
    kv_cache_hit_tokens: int = 0
    kv_cache_miss_tokens: int = 0


class LlmRequest:
    """One in-flight generation request.

    Life cycle: CONTEXT_INIT --(all context chunks done)-->
    GENERATION_IN_PROGRESS --(stop criteria)--> GENERATION_COMPLETE.
    Chunked prefill advances ``context_current_position`` by
    ``context_chunk_size`` per scheduled iteration (reference:
    llm_request.py move_to_next_context_chunk).
    """

    def __init__(self,
                 prompt_token_ids: Sequence[int],
                 sampling_params: Optional[SamplingParams] = None,
                 request_id: Optional[int] = None,
                 lora_task_id: Optional[int] = None,
                 cache_salt: Optional[str] = None,
                 arrival_time: Optional[float] = None,
                 streaming: bool = False,
                 prompt_embeds=None):
        self.request_id = next_request_id() if request_id is None else request_id
        self.prompt_token_ids: List[int] = list(prompt_token_ids)
        if not self.prompt_token_ids:
            raise ValueError("prompt must contain at least one token")
        self.sampling_params = sampling_params or SamplingParams()
        self.lora_task_id = lora_task_id
        self.cache_salt = cache_salt
        self.streaming = streaming
        # the prompt-embedding path: float32 [prompt length, H] (a numpy
        # array or a tensor; the engine keeps it on its device after the
        # first step), rows that are not NaN replace their token's
        # embedding (multimodal features, prompt tables); None: none
        self.prompt_embeds = prompt_embeds
        self.state = LlmRequestState.CONTEXT_INIT
        self.finish_reason = FinishReason.NOT_FINISHED
        self.output_token_ids: List[int] = []
        self.cum_logprob: float = 0.0
        self.logprobs: List[dict] = []          # per generated token: {tok: logprob}
        # SamplingParams.prompt_logprobs: one entry per prompt position
        # (None at position 0), filled by the executor when it takes the
        # request (evaluate/perplexity.py)
        self.prompt_logprobs_result: Optional[list] = None
        # an engine row of a beam group (runtime/beam_search.py): the
        # group forces its next token (host_token_override) and forks its
        # KV; its own SamplingParams carry no beam search
        self.is_beam_row: bool = False
        # speculative draft for the next step, filled by a host drafter on
        # the sync scheduler and verified in one step (the fused EAGLE3
        # window drafts on the device and leaves it empty); tree drafts'
        # parents are not served here, so draft_parents stays None
        self.draft_tokens: List[int] = []
        self.draft_parents: Optional[List[int]] = None
        # a one-model head on the host path (EAGLE3 / MTP with
        # device_window=False): each emitted token with the target's
        # pre-norm hidden row that produced it (float32 [H] on the host),
        # until the head's next catch-up consumes them
        self.eagle_feats: List = []

        # chunked-prefill progress
        self.context_current_position: int = 0
        self.context_chunk_size: int = len(self.prompt_token_ids)
        # set when the request was paused under memory pressure and must
        # recompute its full sequence (prompt + generated so far) as a
        # context phase on resume (reference: pauseRequests.h:47)
        self._recompute_tokens: Optional[List[int]] = None

        # kv bookkeeping (owned by KVCacheManager)
        self.kv_block_ids: List[int] = []
        # VSWA: the sliding layers' blocks in their own pool
        self.kv_block_ids_sw: List[int] = []
        self.num_cached_tokens: int = 0         # prefix tokens reused from cache

        # seq slot assigned by the executor while scheduled
        self.seq_slot: Optional[int] = None
        # guided decoding on the device backend: the slot's grammar state
        # lives in the engine's pool (guided/device_guided.py), set while
        # the request holds its slot
        self.guided_device: bool = False

        # device-side progress (overlap scheduling): number of tokens whose
        # KV has been scheduled/written on device — may run ahead of
        # ``output_token_ids`` by one iteration (reference: overlap loop's
        # py_decoding_iter, py_executor.py:2870)
        self.num_device_tokens: int = 0
        # when the host already knows the next input token (first gen step
        # after prefill in non-overlap mode), bypass the device-side gather
        self.host_token_override: Optional[int] = None
        # tokens this request may emit in the current multi-step decode
        # window (set by the executor after KV pre-allocation)
        self.multi_step_budget: int = 1
        # fused speculative window (runtime/spec_window.py): the emission
        # cap of the current window (set by the executor after KV
        # pre-allocation of budget + d tokens), and whether a prefill step
        # of this engine seeded the draft head's pending pair for the row
        self.spec_budget: int = 1
        self.spec_seeded: bool = False

        self.perf = PerfMetrics(arrival_time=arrival_time or time.monotonic())
        self.priority: float = 0.5

        # streaming: index of last token already emitted to the client
        self.num_tokens_streamed: int = 0

    # ------------------------------------------------------------------ #
    # Lengths
    # ------------------------------------------------------------------ #
    @property
    def prompt_len(self) -> int:
        return len(self.prompt_token_ids)

    @property
    def num_output_tokens(self) -> int:
        return len(self.output_token_ids)

    @property
    def num_total_tokens(self) -> int:
        return self.prompt_len + self.num_output_tokens

    @property
    def max_new_tokens(self) -> int:
        return self.sampling_params.max_tokens

    @property
    def all_token_ids(self) -> List[int]:
        return self.prompt_token_ids + self.output_token_ids

    @property
    def context_token_ids(self) -> List[int]:
        """Tokens the context (prefill) phase must compute KV for: the
        prompt, or — after a MAX_UTILIZATION pause — the prompt plus all
        tokens generated before the pause."""
        if self._recompute_tokens is not None:
            return self._recompute_tokens
        return self.prompt_token_ids

    @property
    def context_len(self) -> int:
        return len(self.context_token_ids)

    # ------------------------------------------------------------------ #
    # Context-phase (chunked prefill)
    # ------------------------------------------------------------------ #
    @property
    def is_context_init_state(self) -> bool:
        return self.state == LlmRequestState.CONTEXT_INIT

    @property
    def is_generation_in_progress(self) -> bool:
        return self.state in (LlmRequestState.GENERATION_IN_PROGRESS,
                              LlmRequestState.GENERATION_TO_COMPLETE)

    @property
    def is_finished(self) -> bool:
        return self.state == LlmRequestState.GENERATION_COMPLETE

    @property
    def is_last_context_chunk(self) -> bool:
        return (self.context_current_position + self.context_chunk_size
                >= self.context_len)

    @property
    def context_remaining_length(self) -> int:
        return self.context_len - self.context_current_position

    def move_to_next_context_chunk(self) -> None:
        self.context_current_position = min(
            self.context_len,
            self.context_current_position + self.context_chunk_size)

    def pause_for_recompute(self) -> None:
        """MAX_UTILIZATION pause: the executor has released this request's
        KV; reset to CONTEXT_INIT so the whole sequence (prompt + generated
        so far) recomputes when capacity frees up (reference:
        capacityScheduler.cpp MaxUtilizationScheduler + pauseRequests.h:47;
        freed blocks stay in the reuse tree, so resume usually re-onboards
        the prefix instead of recomputing it)."""
        self._recompute_tokens = self.prompt_token_ids + self.output_token_ids
        self.state = LlmRequestState.CONTEXT_INIT
        self.context_current_position = 0
        self.context_chunk_size = len(self._recompute_tokens)
        self.num_device_tokens = 0
        self.host_token_override = None
        self.draft_tokens = []
        self.kv_block_ids = []
        self.kv_block_ids_sw = []
        self.num_cached_tokens = 0

    # ------------------------------------------------------------------ #
    # Token acceptance / stop criteria
    # ------------------------------------------------------------------ #
    def add_output_token(self, token_id: int,
                         logprob: Optional[float] = None) -> bool:
        """Append one accepted token; returns True if the request finished."""
        now = time.monotonic()
        if not self.output_token_ids:
            self.perf.first_token_time = now
        self.perf.last_token_time = now
        self.output_token_ids.append(token_id)
        if logprob is not None:
            self.cum_logprob += logprob
            self.logprobs.append({token_id: logprob})
        return self._check_stop(token_id)

    def _check_stop(self, last_token: int) -> bool:
        sp = self.sampling_params
        if self.num_output_tokens >= sp.min_tokens:
            if last_token in sp.stop_id_list():
                self._finish(FinishReason.END_ID if last_token == sp.end_id
                             else FinishReason.STOP_WORDS)
                return True
        if self.num_output_tokens >= sp.max_tokens:
            self._finish(FinishReason.LENGTH)
            return True
        return False

    def _finish(self, reason: FinishReason) -> None:
        self.state = LlmRequestState.GENERATION_COMPLETE
        self.finish_reason = reason

    def cancel(self) -> None:
        self._finish(FinishReason.CANCELLED)

    def finish_by_reason(self, reason: FinishReason) -> None:
        self._finish(reason)

    # ------------------------------------------------------------------ #
    def __repr__(self) -> str:  # pragma: no cover
        return (f"LlmRequest(id={self.request_id}, state={self.state.name}, "
                f"prompt={self.prompt_len}t, out={self.num_output_tokens}t)")
