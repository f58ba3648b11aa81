"""Waiting-queue policies for request admission.

Port of ``tensorrt_llm_tpu/runtime/waiting_queue.py``, unchanged (pure
host code) — the scheduler-v2 front stage: submitted
requests wait here, ordered by policy, until the executor admits them
into the active set; deferred requests prepend back preserving order.
"""
from __future__ import annotations

import heapq
import itertools
from abc import ABC, abstractmethod
from collections import deque
from typing import Iterable, Iterator, List, Optional

from .request import LlmRequest


class WaitingQueue(ABC):
    @abstractmethod
    def add_request(self, request: LlmRequest) -> None: ...

    def add_requests(self, requests: Iterable[LlmRequest]) -> None:
        for r in requests:
            self.add_request(r)

    @abstractmethod
    def pop_request(self) -> LlmRequest: ...

    @abstractmethod
    def peek_request(self) -> LlmRequest: ...

    @abstractmethod
    def prepend_request(self, request: LlmRequest) -> None:
        """Return a deferred request to the FRONT (keeps its turn)."""

    def prepend_requests(self, requests: Iterable[LlmRequest]) -> None:
        for r in reversed(list(requests)):
            self.prepend_request(r)

    @abstractmethod
    def remove_by_ids(self, request_ids: set) -> None: ...

    @abstractmethod
    def __len__(self) -> int: ...

    def __bool__(self) -> bool:
        return len(self) > 0

    @abstractmethod
    def __iter__(self) -> Iterator[LlmRequest]: ...


class FCFSWaitingQueue(WaitingQueue):
    """Arrival order (reference: waiting_queue.py:96)."""

    def __init__(self):
        self._q: deque = deque()

    def add_request(self, request: LlmRequest) -> None:
        self._q.append(request)

    def pop_request(self) -> LlmRequest:
        return self._q.popleft()

    def peek_request(self) -> LlmRequest:
        return self._q[0]

    def prepend_request(self, request: LlmRequest) -> None:
        self._q.appendleft(request)

    def remove_by_ids(self, request_ids: set) -> None:
        self._q = deque(r for r in self._q
                        if r.request_id not in request_ids)

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(self._q)


class PriorityWaitingQueue(WaitingQueue):
    """Higher ``LlmRequest.priority`` first; FIFO within a priority
    level (reference: PriorityWaitingQueue — stable heap with an
    arrival tiebreaker). Prepended (deferred) requests keep their
    original arrival rank."""

    def __init__(self):
        self._heap: List[tuple] = []
        self._tick = itertools.count()
        self._removed: set = set()

    def _key(self, request: LlmRequest, tick: int) -> tuple:
        return (-float(getattr(request, "priority", 0.5) or 0.5), tick)

    def add_request(self, request: LlmRequest) -> None:
        tick = next(self._tick)
        request._wq_tick = tick
        heapq.heappush(self._heap, (*self._key(request, tick), request))

    def prepend_request(self, request: LlmRequest) -> None:
        tick = getattr(request, "_wq_tick", None)
        if tick is None:
            tick = -next(self._tick)       # jump the line if unknown
        heapq.heappush(self._heap, (*self._key(request, tick), request))

    def _compact(self) -> None:
        while self._heap and \
                self._heap[0][2].request_id in self._removed:
            _, _, r = heapq.heappop(self._heap)
            self._removed.discard(r.request_id)

    def pop_request(self) -> LlmRequest:
        self._compact()
        if not self._heap:
            raise IndexError("pop from empty waiting queue")
        return heapq.heappop(self._heap)[2]

    def peek_request(self) -> LlmRequest:
        self._compact()
        if not self._heap:
            raise IndexError("peek from empty waiting queue")
        return self._heap[0][2]

    def remove_by_ids(self, request_ids: set) -> None:
        self._removed |= set(request_ids)

    def __len__(self) -> int:
        return sum(1 for _, _, r in self._heap
                   if r.request_id not in self._removed)

    def __iter__(self):
        return (r for _, _, r in sorted(self._heap, key=lambda e: e[:2])
                if r.request_id not in self._removed)


def create_waiting_queue(policy: str) -> WaitingQueue:
    if policy == "fcfs":
        return FCFSWaitingQueue()
    if policy == "priority":
        return PriorityWaitingQueue()
    raise ValueError(f"unknown waiting queue policy {policy!r}")
