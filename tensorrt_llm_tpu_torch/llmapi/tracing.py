"""Per-request tracing: W3C trace context in, OTLP/HTTP JSON spans out.

Port of ``tensorrt_llm_tpu/llmapi/tracing.py``, dependency-free as
there: ``parse_traceparent`` / ``format_traceparent`` read and write the
W3C ``traceparent`` header (00-<trace id/32>-<span id/16>-<flags>), and
``OtlpJsonExporter`` posts buffered spans as OTLP/HTTP JSON
(``resourceSpans``) to ``OTEL_EXPORTER_OTLP_TRACES_ENDPOINT`` from a
daemon thread, so that the executor loop never waits on the collector.
``RequestTracer`` builds one ``llm_request`` span per finished request
whose submission carried a trace context (``LLM.generate_async(...,
trace_headers=...)``; with ``OTEL_TRACES_ALWAYS_ON=1`` every request,
on a fresh trace), with the gen_ai attributes and the queued /
scheduled / first_token / finished events of the request's
``PerfMetrics``; ``RequestTracer.from_env`` is None without an
endpoint.
"""
from __future__ import annotations

import json
import os
import queue
import re
import secrets
import threading
import time
import urllib.request
from typing import List, Optional, Tuple

from ..logger import logger

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def parse_traceparent(header: Optional[str]
                      ) -> Optional[Tuple[str, str, int]]:
    """-> (trace_id, parent_span_id, flags) or None if absent/invalid."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    _, trace_id, span_id, flags = m.groups()
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, int(flags, 16)


def format_traceparent(trace_id: str, span_id: str,
                       flags: int = 1) -> str:
    return f"00-{trace_id}-{span_id}-{flags:02x}"


def extract_trace_context(headers) -> Optional[Tuple[str, str, int]]:
    """From an HTTP header mapping (case-insensitive get)."""
    if headers is None:
        return None
    get = getattr(headers, "get", None)
    if get is None:
        return None
    return parse_traceparent(get("traceparent") or get("Traceparent"))


class OtlpJsonExporter:
    """Buffered OTLP/HTTP JSON span exporter (no SDK dependency)."""

    def __init__(self, endpoint: str, service_name: str = "tensorrt_llm_tpu_torch",
                 flush_interval: float = 2.0, max_batch: int = 256):
        self.endpoint = endpoint.rstrip("/")
        if not self.endpoint.endswith("/v1/traces"):
            self.endpoint += "/v1/traces"
        self.service_name = service_name
        self._q: "queue.Queue" = queue.Queue(maxsize=4096)
        self._flush_interval = flush_interval
        self._max_batch = max_batch
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="tllm-otlp-export")
        self._thread.start()

    def export(self, span: dict) -> None:
        try:
            self._q.put_nowait(span)
        except queue.Full:
            pass                      # never stall the serving path

    def _drain(self) -> List[dict]:
        out = []
        while len(out) < self._max_batch:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                break
        return out

    def _run(self):
        while not self._stop.is_set():
            self._stop.wait(self._flush_interval)
            self.flush()

    def flush(self) -> None:
        spans = self._drain()
        if not spans:
            return
        payload = {
            "resourceSpans": [{
                "resource": {"attributes": [{
                    "key": "service.name",
                    "value": {"stringValue": self.service_name}}]},
                "scopeSpans": [{
                    "scope": {"name": "tensorrt_llm_tpu_torch.llmapi"},
                    "spans": spans}],
            }]
        }
        try:
            req = urllib.request.Request(
                self.endpoint, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=5.0).read()
        except Exception as e:        # collector down: drop, don't spin
            logger.debug("OTLP export failed: %s", e)

    def shutdown(self):
        self._stop.set()
        self.flush()


def _attr(key, value):
    if isinstance(value, bool):
        return {"key": key, "value": {"boolValue": value}}
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": str(value)}}
    if isinstance(value, float):
        return {"key": key, "value": {"doubleValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


class RequestTracer:
    """Builds one ``llm_request`` span per finished request.

    ``trace_ctx`` comes from the inbound traceparent (sampled requests
    only, like the reference); with OTEL_TRACES_ALWAYS_ON=1 every
    request gets a fresh root trace."""

    def __init__(self, exporter: Optional[OtlpJsonExporter] = None):
        if exporter is None:
            ep = os.environ.get("OTEL_EXPORTER_OTLP_TRACES_ENDPOINT")
            exporter = OtlpJsonExporter(ep) if ep else None
        self.exporter = exporter
        self.always = os.environ.get("OTEL_TRACES_ALWAYS_ON") == "1"
        # monotonic -> wall clock (perf timestamps are monotonic)
        self._wall_offset = time.time() - time.monotonic()

    @classmethod
    def from_env(cls) -> Optional["RequestTracer"]:
        t = cls()
        return t if t.exporter is not None else None

    def _nanos(self, mono: float) -> str:
        return str(int((mono + self._wall_offset) * 1e9))

    def on_request_finished(self, req) -> None:
        ctx = getattr(req, "trace_ctx", None)
        if ctx is None and not self.always:
            return
        if self.exporter is None:
            return
        trace_id = ctx[0] if ctx else secrets.token_hex(16)
        parent = ctx[1] if ctx else ""
        p = req.perf
        start = p.arrival_time
        end = p.last_token_time or time.monotonic()
        events = []
        for name, t in (("queued", p.arrival_time),
                        ("scheduled", p.first_scheduled_time),
                        ("first_token", p.first_token_time),
                        ("finished", end)):
            if t:
                events.append({"name": name,
                               "timeUnixNano": self._nanos(t)})
        span = {
            "traceId": trace_id,
            "spanId": secrets.token_hex(8),
            "parentSpanId": parent,
            "name": "llm_request",
            "kind": 2,  # SERVER
            "startTimeUnixNano": self._nanos(start),
            "endTimeUnixNano": self._nanos(end),
            "attributes": [
                _attr("gen_ai.request.id", req.request_id),
                _attr("gen_ai.usage.prompt_tokens", req.prompt_len),
                _attr("gen_ai.usage.completion_tokens",
                      req.num_output_tokens),
                _attr("gen_ai.response.finish_reason",
                      req.finish_reason.name.lower()),
                _attr("gen_ai.request.max_tokens",
                      req.sampling_params.max_tokens),
                _attr("gen_ai.latency.time_to_first_token",
                      max(0.0, p.first_token_time - p.arrival_time)
                      if p.first_token_time else 0.0),
                _attr("gen_ai.latency.kv_cache_hit_tokens",
                      getattr(p, "kv_cache_hit_tokens", 0)),
            ],
            "events": events,
            "status": {"code": 1},
        }
        self.exporter.export(span)
