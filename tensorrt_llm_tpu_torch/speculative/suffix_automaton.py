"""Suffix-automaton drafter (model-free speculation).

Port of ``tensorrt_llm_tpu/speculative/suffix_automaton.py``, a copy.
Behavioral reference: tensorrt_llm/_torch/speculative/suffix_automaton.py
+ sa_worker.py (the Baseten sa_spec scheme): a per-request suffix
automaton over the full token history (prompt + outputs) finds the
LONGEST suffix of the stream that occurred earlier, and proposes the
tokens that followed that earlier occurrence. Unlike NGram's fixed-n
lookup, the match length is unbounded (amortized O(1) per token), and a
``threshold`` suppresses weak matches — the reference reports up to 40%
acceptance gains over NGram on repetitive/code workloads.

This implementation is pure host Python (the reference uses a C++/CUDA
native kernel so the automaton advances CUDA-graph-compatibly; here the
executor's host drafting slot serves the same role — drafting runs on
the sync scheduler like every host drafter).

The automaton is the classic online suffix automaton (linear states,
incremental extend). Each state stores a representative end position of
its substring class, so the continuation after any match is a direct
slice of the history. The MATCH pointer advances BEFORE each token
extends the automaton, so matches always refer to strictly-earlier
occurrences.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..runtime.request import LlmRequest
from .interface import Drafter, SpeculationGate


class _SAM:
    """Online suffix automaton with a rolling longest-suffix match."""

    __slots__ = ("next", "link", "length", "endpos", "last",
                 "cur", "cur_len", "n_fed", "history")

    def __init__(self):
        self.next: List[Dict[int, int]] = [dict()]
        self.link: List[int] = [-1]
        self.length: List[int] = [0]
        self.endpos: List[int] = [-1]
        self.last = 0
        # match pointer (longest suffix occurring strictly earlier)
        self.cur = 0
        self.cur_len = 0
        self.n_fed = 0
        self.history: List[int] = []

    # ---- automaton extend (Blumer et al.; endpos = first end index) --- #
    def _add_state(self, length: int, endpos: int) -> int:
        self.next.append(dict())
        self.link.append(-1)
        self.length.append(length)
        self.endpos.append(endpos)
        return len(self.next) - 1

    def _extend(self, c: int, pos: int) -> None:
        cur = self._add_state(self.length[self.last] + 1, pos)
        p = self.last
        while p >= 0 and c not in self.next[p]:
            self.next[p][c] = cur
            p = self.link[p]
        if p < 0:
            self.link[cur] = 0
        else:
            q = self.next[p][c]
            if self.length[p] + 1 == self.length[q]:
                self.link[cur] = q
            else:
                clone = self._add_state(self.length[p] + 1, self.endpos[q])
                self.next[clone] = dict(self.next[q])
                self.link[clone] = self.link[q]
                while p >= 0 and self.next[p].get(c) == q:
                    self.next[p][c] = clone
                    p = self.link[p]
                self.link[q] = clone
                self.link[cur] = clone
        self.last = cur

    # ---- rolling match: advance BEFORE extending ---------------------- #
    def feed(self, c: int) -> None:
        st, ln = self.cur, self.cur_len
        while st >= 0 and c not in self.next[st]:
            st = self.link[st]
            ln = self.length[st] if st >= 0 else 0
        if st < 0:
            self.cur, self.cur_len = 0, 0
        else:
            self.cur = self.next[st][c]
            self.cur_len = ln + 1
        self._extend(c, len(self.history))
        self.history.append(c)
        self.n_fed += 1

    def match_continuation(self, k: int) -> List[int]:
        """Tokens that followed the matched earlier occurrence."""
        if self.cur == 0 or self.cur_len == 0:
            return []
        start = self.endpos[self.cur] + 1
        return self.history[start:start + k]


class SuffixAutomatonDrafter(Drafter):
    """Per-request SA states keyed by request id (the reference's
    SuffixAutomatonManager slot pool, resource_manager-integrated;
    here lifetime follows the executor's drop_request callback)."""

    def __init__(self, max_draft_len: int = 4, threshold: int = 2,
                 max_concurrency: Optional[int] = None):
        super().__init__(max_draft_len)
        self.threshold = max(1, threshold)
        self.gate = SpeculationGate(max_concurrency)
        self._sam: Dict[int, _SAM] = {}

    def prepare_draft_tokens(self, requests: Sequence[LlmRequest]) -> None:
        if not self.gate.enabled(len(requests)):
            # reference: speculation_gate.py auto-disables at high
            # concurrency (drafting overhead outweighs acceptance)
            for req in requests:
                req.draft_tokens = []
            return
        for req in requests:
            sam = self._sam.get(req.request_id)
            if sam is None:
                sam = self._sam[req.request_id] = _SAM()
            hist = req.all_token_ids
            for c in hist[sam.n_fed:]:
                sam.feed(int(c))
            if sam.cur_len < self.threshold:
                req.draft_tokens = []
                continue
            req.draft_tokens = sam.match_continuation(self.max_draft_len)

    def drop_request(self, request_id: int) -> None:
        self._sam.pop(request_id, None)
