"""Executor watchdog.

Port of ``tensorrt_llm_tpu/runtime/hang_detector.py``, unchanged.

Mirrors the reference ``HangDetector`` (reference:
tensorrt_llm/_torch/pyexecutor/hang_detector.py:10-60): the loop calls
``checkpoint()`` every iteration; if no checkpoint arrives within the
timeout, all python thread stacks are dumped so a wedged step (device
hang, deadlocked transfer) is diagnosable, then an optional callback
fires (e.g. abort the process).
"""
from __future__ import annotations

import faulthandler
import sys
import threading
import time
from typing import Callable, Optional

from ..logger import logger


class HangDetector:
    def __init__(self, timeout_s: float = 300.0,
                 on_hang: Optional[Callable] = None):
        self.timeout_s = timeout_s
        self.on_hang = on_hang
        self._last = time.monotonic()
        self._armed = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="tllm-hang-detector")
        self._thread.start()

    def arm(self) -> None:
        self._last = time.monotonic()
        self._armed.set()

    def checkpoint(self) -> None:
        self._last = time.monotonic()

    def disarm(self) -> None:
        self._armed.clear()

    def stop(self) -> None:
        self._stop.set()

    def _watch(self) -> None:
        while not self._stop.is_set():
            time.sleep(min(self.timeout_s / 4, 10.0))
            if not self._armed.is_set():
                continue
            if time.monotonic() - self._last > self.timeout_s:
                logger.error(
                    "executor hang detected (> %.0fs without progress); "
                    "dumping stacks", self.timeout_s)
                faulthandler.dump_traceback(file=sys.stderr)
                self._armed.clear()
                if self.on_hang is not None:
                    self.on_hang()


class ErrorBudget:
    """Tolerate N recoverable per-request errors before escalating
    (reference: _torch/pyexecutor/error_classification.py:44,72)."""

    RECOVERABLE = (TimeoutError, ConnectionError)

    def __init__(self, budget: int = 3):
        self.budget = budget
        self._count = 0

    def classify(self, err: Exception) -> str:
        if isinstance(err, self.RECOVERABLE):
            return "recoverable"
        if isinstance(err, MemoryError) or "RESOURCE_EXHAUSTED" in str(err):
            return "oom"
        return "fatal"

    def consume(self, err: Exception) -> bool:
        """Returns True if execution may continue."""
        kind = self.classify(err)
        if kind == "recoverable":
            self._count += 1
            return self._count <= self.budget
        return False
