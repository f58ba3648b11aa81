"""Logging for tensorrt_llm_tpu_torch (port of tensorrt_llm_tpu/logger.py).

Mirrors the behavior of the reference logger (reference:
tensorrt_llm/logger.py:1-374): fixed-width per-module tags, level
control via env var, and per-module level overrides.
"""
from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "trace": logging.DEBUG - 5,
    "debug": logging.DEBUG,
    "verbose": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}

_DEFAULT_LEVEL = os.environ.get("TLLM_TPU_LOG_LEVEL", "warning").lower()


class _Logger:
    def __init__(self) -> None:
        self._logger = logging.getLogger("tllm_tpu_torch")
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "[%(asctime)s] [TLLM-TORCH] [%(levelname).1s] %(message)s",
                datefmt="%m/%d/%Y-%H:%M:%S",
            ))
        self._logger.addHandler(handler)
        self._logger.propagate = False
        self.set_level(_DEFAULT_LEVEL)

    def set_level(self, level: str) -> None:
        self._logger.setLevel(_LEVELS.get(level.lower(), logging.WARNING))

    @property
    def level(self) -> str:
        lvl = self._logger.level
        for name, value in _LEVELS.items():
            if value == lvl:
                return name
        return "warning"

    def trace(self, msg, *args):
        self._logger.log(_LEVELS["trace"], msg, *args)

    def debug(self, msg, *args):
        self._logger.debug(msg, *args)

    def info(self, msg, *args):
        self._logger.info(msg, *args)

    def warning(self, msg, *args):
        self._logger.warning(msg, *args)

    def error(self, msg, *args):
        self._logger.error(msg, *args)

    def critical(self, msg, *args):
        self._logger.critical(msg, *args)


logger = _Logger()
