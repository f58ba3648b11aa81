"""Guided decoder: builds per-iteration logit bitmasks.

Port of ``tensorrt_llm_tpu/guided/guided_decoder.py``, unchanged but for
how the mask travels: the step packs it to a bit per token on its way to
the device (``ModelEngine._step_inputs``).

Role of the reference ``GuidedDecoder`` (reference:
tensorrt_llm/_torch/pyexecutor/guided_decoder.py:140 — compiles grammars
per request, fills token bitmasks each iteration, applies them to logits
on-stream; kernel logitsBitmask.cu). Here the mask is a host-built
[S, V] bool array handed to the step, applied as logits masking
before sampling. Guided requests force sync (non-overlap) scheduling —
the matcher must observe token t before masking step t+1.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..runtime.request import LlmRequest
from ..runtime.scheduler import ScheduledRequests
from .grammar_matcher import GrammarMatcher, MatcherFactory, TokenTable


class GuidedDecoder:
    def __init__(self, token_table: TokenTable, max_batch_size: int):
        self.factory = MatcherFactory(token_table)
        self.table = token_table
        self.vocab_size = token_table.vocab_size
        self.max_batch_size = max_batch_size
        self._matchers: Dict[int, GrammarMatcher] = {}
        self.device = None  # DeviceGuidedManager when device-resident

    # ------------------------------------------------------------------ #
    # device-resident mode (guided/device_guided.py): the grammar walk
    # lives on the card, so guided requests ride the overlap scheduler and
    # the K-step decode window with zero per-token host work
    # ------------------------------------------------------------------ #
    def attach_engine(self, engine, pool_states: int = 8192) -> None:
        from .device_guided import DeviceGuidedManager
        self.device = DeviceGuidedManager(self.factory, self.table,
                                          engine, pool_states)

    def on_slot_assigned(self, req: LlmRequest, engine) -> None:
        """Device admission: land (or share) the grammar segment and point
        the request's slot at its state — resumed past any tokens already
        generated (pause/evict recompute)."""
        gp = req.sampling_params.guided_decoding
        if self.device is None or gp is None:
            return
        self.device.acquire(gp)
        state = self.device.state_after(gp, req.output_token_ids)
        engine.guided_set_state(req.seq_slot, int(state))
        req.guided_device = True

    def on_slot_released(self, req: LlmRequest, engine) -> None:
        if self.device is None or not getattr(req, "guided_device", False):
            return
        engine.guided_set_state(req.seq_slot, -1)
        self.device.release(req.sampling_params.guided_decoding)
        req.guided_device = False

    def has_guided(self, batch: ScheduledRequests) -> bool:
        return any(r.sampling_params.guided_decoding is not None
                   and not getattr(r, "guided_device", False)
                   for r in batch.all_requests)

    def build_mask(self, batch: ScheduledRequests) -> Optional[np.ndarray]:
        """bool[S, V] per batch row; all-True rows for unguided requests.
        Masks apply only to rows that sample real output tokens."""
        if not self.has_guided(batch):
            return None
        mask = np.ones((self.max_batch_size, self.vocab_size), bool)
        reqs = batch.context_requests + batch.generation_requests
        for i, req in enumerate(reqs):
            gp = req.sampling_params.guided_decoding
            if gp is None or getattr(req, "guided_device", False):
                continue  # device-resident rows mask in-graph
            if req.is_context_init_state and not req.is_last_context_chunk:
                continue  # no output sampled this step
            m = self._matchers.get(req.request_id)
            if m is None:
                m = self.factory.create(gp)
                if m is None:
                    continue
                self._matchers[req.request_id] = m
            mask[i, :self.vocab_size] = m.fill_next_token_bitmask()
        return mask

    def observe_token(self, req: LlmRequest, token_id: int) -> None:
        if getattr(req, "guided_device", False):
            return  # the device walk already advanced
        m = self._matchers.get(req.request_id)
        if m is not None:
            m.accept_token(token_id)

    def rollback(self, req: LlmRequest, n: int) -> None:
        m = self._matchers.get(req.request_id)
        if m is not None and n > 0:
            m.rollback(n)

    def drop(self, request_id: int) -> None:
        self._matchers.pop(request_id, None)
