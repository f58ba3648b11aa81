"""Per-request error isolation and the executor error budget.

Port of ``tensorrt_llm_tpu/runtime/error_isolation.py``
(``classify_error``, ``RequestError``, ``ErrorBudget``,
``explain_stage_oom``): the budget's arithmetic and the request error are
unchanged; the patterns describe the CUDA runtime instead of the TPU's,
and the stage hints name this package's knobs.

- *Immediate fatal*: a sticky CUDA error (an illegal address, a
  device-side assert, a failed launch, a misaligned address, a failed
  cuBLAS execution, any ``CUDA error:`` raised after a launch) poisons the
  context, so no later launch can succeed; CUDA also reports it at the
  next synchronization, which may belong to a later iteration's requests,
  so recovering would fail the wrong requests and keep serving on a dead
  context. A failed CUDA-graph capture (``GraphRunner`` raises) is fatal
  too: the step it was for has no recorded path.
- *Severe*: the device ran out of memory (``torch.cuda.OutOfMemoryError``
  says "CUDA out of memory"), possibly a transient spike under load; it
  drains the budget five times faster.
- *Transient*: everything else, such as host work of one request (a
  logits processor, a grammar compile) that raised.

Dependency-free so it can be unit-tested anywhere.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Optional

IMMEDIATE_FATAL_PATTERNS = (
    "illegal memory access",
    "an illegal instruction",
    "device-side assert",
    "unspecified launch failure",
    "misaligned address",
    "cublas_status_execution_failed",
    "cuda error:",
    "cuda graph capture failed",
    "operation not permitted when stream is capturing",
)

SEVERE_ERROR_PATTERNS = (
    "cuda out of memory",
    "out of memory",
    r"\boom\b",
    "allocation failure",
)


def classify_error(error_msg: str) -> str:
    """Classify an error message: immediate_fatal | severe | transient."""
    low = error_msg.lower()
    for p in IMMEDIATE_FATAL_PATTERNS:
        if p in low:
            return "immediate_fatal"
    for p in SEVERE_ERROR_PATTERNS:
        if re.search(p, low) if "\\b" in p else p in low:
            return "severe"
    return "transient"


class RequestError(Exception):
    """An error attributable to exactly one request.

    Raised from per-request host work inside the executor loop (grammar
    compile, logits processor). The loop fails only the culprit request
    and keeps serving the rest of the batch.
    """

    def __init__(self, request, stage: str, cause: Exception):
        super().__init__(f"request {getattr(request, 'request_id', '?')} "
                         f"failed at {stage}: {cause!r}")
        self.request = request
        self.stage = stage
        self.cause = cause


@dataclasses.dataclass
class ErrorBudget:
    """Token-bucket budget deciding when loop errors become fatal.

    Each recoverable error deducts ``cost`` (severe errors cost 5x);
    the budget refills at ``recovery_rate``/s of error-free time. When
    the bucket empties, the next error is promoted to fatal. Immediate-
    fatal classes bypass the bucket.
    """

    budget: float = 1.0
    recovery_rate: float = 0.1
    cost: float = 0.1
    last_error_time: Optional[float] = None

    def consume(self, error_msg: str, now: Optional[float] = None) -> bool:
        """Record one error. Returns True if it must be treated FATAL."""
        severity = classify_error(error_msg)
        if severity == "immediate_fatal":
            return True
        now = time.monotonic() if now is None else now
        if self.last_error_time is not None:
            self.budget = min(
                1.0, self.budget + (now - self.last_error_time)
                * self.recovery_rate)
        self.last_error_time = now
        self.budget -= self.cost * (5.0 if severity == "severe" else 1.0)
        return self.budget < 0.0


# Stage-tagged OOM explanation: the LLM's build tags its stages
# (llmapi/llm.py ``_creation_stage``) so that an allocation failure names
# the knob that relieves it.
_STAGE_HINTS = {
    "weights": ("loading model weights",
                "use a quantized checkpoint or quant_config "
                "(W4A16_AWQ, W8A16, ...)"),
    "kv_pool": ("allocating the paged KV-cache pool",
                "lower kv_cache_config.free_gpu_memory_fraction, "
                "kv_cache_config.max_tokens or max_batch_size"),
    "warmup": ("capturing the serving CUDA graphs",
               "lower max_batch_size or decode_multi_step, or pass "
               "enable_warmup=False"),
    "forward": ("running a forward step",
                "lower max_batch_size or max_num_tokens"),
}


def explain_stage_oom(stage: str, exc: Exception) -> str:
    what, hint = _STAGE_HINTS.get(stage, (stage, "reduce memory knobs"))
    return (f"out of device memory while {what}: {exc}. Try: {hint}.")
