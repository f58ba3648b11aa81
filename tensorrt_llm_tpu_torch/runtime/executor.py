"""Continuous-batching executor loop.

Port of ``tensorrt_llm_tpu/runtime/executor.py`` (``PyExecutor``): one
background thread runs fetch -> schedule -> allocate -> forward ->
process-previous -> respond. Sampled tokens stay on the device indexed by
sequence slot and the next step gathers them there, so the host processes
iteration n-1's tokens (up to ``pipeline_depth`` iterations behind) while
the device executes iteration n. Pure-decode batches run K-step decode
windows (``ModelEngine.forward_multi_step``); a batch with context and
generation rows splits into a prefill step and a decode window, and with
``mixed_window_ctx`` > 0 context chunks ride inside that window's steps
instead of the prefill step. The serving schedule of the JAX executor
comes along: the batching-wait (``decode_wait_occupancy``: decode rows
sit out while context runs and the pool is under the target) and the
TTFT budget (``ttft_slo_ms``: windows shrink to K/4 while a request waits
past it for its first token).

With an EAGLE3 or MTP head in the fused window
(``LLM(speculative_config=...)``), decode rows
that qualify (``_spec_row_ok``: seeded by a prefill step of this engine,
no penalties, few enough stop ids, room left) take the fused speculative
window (``ModelEngine.forward_spec_window``, runtime/spec_window.py)
instead: K propose -> verify -> accept iterations per dispatch, riding
the same overlap pipeline. A decode batch splits its qualifying rows off
into their own window; the others take single steps (no multi-step
window runs beside a drafter, as in the JAX package). A prompt's last
chunk, run in a prefill step, seeds its row's draft head on the device
(``spec_seed``).

With a host drafter (NGram, suffix automaton, AUTO, a user's drafter,
the two-model drafter of DRAFT_TARGET / PARD, an EAGLE3 or MTP head with
``device_window=False``) the executor is the JAX package's sync path: no
overlap (the drafter needs the host's token history one step ahead), no
multi-step window, and before each step ``_prepare_drafts`` fills the
decode rows' ``draft_tokens``; a one-model head (``wants_hidden_states``)
gets every emitted token with the target's pre-norm hidden row that
produced it (``LlmRequest.eagle_feats``, float32 on the host: each single
step collects the hidden rows, the JAX executor.py:1719-1726); the step
verifies them (``ModelEngine.forward_step`` with G logits rows per row)
and result processing accepts the longest matching prefix plus one bonus
token, discards tokens past a stop, rolls the device count back and
rewinds the rejected drafts' KV blocks.

The sampling surface follows the JAX executor: the no-repeat-ngram
history and the embedding bias land in the engine's slot state when a
request takes its slot; bad-word ids ride each single step
(``_apply_bad_words``); on the sync scheduler a logits processor sees
its row's processed logits after the step and the row is re-sampled on
the host (``_host_sample``, numpy), the result overriding the device's
sample; beam search runs each beam as an engine row
(runtime/beam_search.py), re-ranked after every step
(``_update_beam_groups``); ``prompt_logprobs`` come from one
teacher-forced forward (evaluate/perplexity.py) that this thread runs when
it takes the request, since a launch from another thread during a CUDA
graph capture would break the capture. Rows with bad words, a processor,
beams or top-k logprobs leave K-step windows, and rows with bad words,
an embedding bias, penalties (no-repeat-ngram among them), a processor
or beams leave the fused speculative window.

Guided decoding follows the JAX executor (guided/): with the device
backend a request's grammar segment lands in the engine's pool and its
slot's state is set when it takes its slot (``on_slot_assigned``: a full
pool defers the request, a grammar that can never fit fails it alone),
and its rows ride the overlap scheduler and K-step windows, masked and
advanced on the device; with the host backend (``"dfa-host"``) the
scheduler is the sync one, each single step carries the rows' [S, V]
mask (``build_mask``) and each accepted token advances the host matcher
(``observe_token``), and such rows leave K-step windows.

The loop is supervised as in the JAX package (runtime/error_isolation.py):
an exception in one request's host work (a logits processor, a grammar
compile, a prompt-logprobs forward) fails that request alone with a
``RequestError``; any other loop exception fails the requests of the
iteration it hit and of the dropped in-flight results, and the loop
serves on, until the error budget runs out or the error is fatal (a
sticky CUDA error, a failed graph capture), when every open request
fails. ``cancel`` ends a request (``FinishReason.CANCELLED``) at the next
iteration, or at admission when it is still queued; a ``HangDetector``
dumps every thread's stack when an iteration takes longer than its
timeout; each iteration appends an ``IterationStats`` to
``stats_history``.

LoRA rows (``lora_task_id``) take single steps: no K-step window, no
rider window for their prompts, no speculative window (the JAX
executor.py:1198, :1221, :1400). A KV connector (runtime/kv_connector.py)
is driven at the JAX package's sites: ``query_match`` / ``after_alloc``
at admission, ``begin_batch`` after the iteration's allocation,
``on_request_finished`` (blocks parked until an asynchronous save lands,
``poll_finished_saves`` in ``_reap_finished``).

This executor is the JAX package's single-engine role only: it has no
leader, follower or attention-DP roles, so their branches of the
schedule are not ported. Not ported either: tree drafts and
disaggregation.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ..logger import logger
from ..ops.sampling_ops import NGRAM_MAX
from .beam_search import BeamGroup, make_beam_rows
from .error_isolation import ErrorBudget, RequestError
from .hang_detector import HangDetector
from .kv_cache_manager import KVCacheManager, NoFreeBlocksError
from .model_engine import HostFuture, ModelEngine
from .request import FinishReason, LlmRequest, LlmRequestState
from .scheduler import RequestScheduler, ScheduledRequests
from .waiting_queue import create_waiting_queue


@dataclasses.dataclass
class CompletionOutput:
    index: int
    text: str = ""
    token_ids: List[int] = dataclasses.field(default_factory=list)
    cumulative_logprob: Optional[float] = None
    logprobs: Optional[list] = None
    finish_reason: Optional[str] = None


class GenerationResult:
    """Future-like handle for one request. With ``postproc_pool`` (the
    executor's ``num_postprocess_workers`` threads, the JAX
    executor.py:40-55) each streamed chunk is decoded on the pool and the
    stream queue holds its future, so chunks keep their order; the final
    output is built there too."""

    def __init__(self, request: LlmRequest, tokenizer=None,
                 streaming: bool = False, postproc_pool=None):
        self.request = request
        self.tokenizer = tokenizer
        self.streaming = streaming
        self._pool = postproc_pool
        self._done = threading.Event()
        self._stream_queue: "queue.Queue" = queue.Queue()
        self.outputs: List[CompletionOutput] = []
        self.error: Optional[Exception] = None

    @property
    def request_id(self) -> int:
        return self.request.request_id

    @property
    def prompt_token_ids(self) -> List[int]:
        return self.request.prompt_token_ids

    @property
    def prompt_logprobs(self) -> Optional[list]:
        """``SamplingParams.prompt_logprobs``'s per-position dicts (None
        when not asked for)."""
        return self.request.prompt_logprobs_result

    @property
    def finished(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> "GenerationResult":
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished within {timeout}s")
        if self.error is not None:
            raise self.error
        return self

    def __iter__(self):
        """Streaming iteration: yields incremental CompletionOutput."""
        while True:
            item = self._stream_queue.get()
            if item is None:
                break
            if isinstance(item, Future):
                item = item.result()
            yield item

    # executor-side callbacks ------------------------------------------- #
    def _on_tokens(self, new_tokens: List[int]) -> None:
        if self.streaming:
            toks = list(new_tokens)

            def make():
                return CompletionOutput(index=0, token_ids=toks,
                                        text=self._safe_decode(toks))
            self._stream_queue.put(make() if self._pool is None
                                   else self._pool.submit(make))

    def _on_finish(self, inline: bool = False) -> None:
        """The request is done: its output is built (on the postprocess
        pool when there is one, unless ``inline``) and waiters wake."""
        if self._pool is not None and not inline:
            self._pool.submit(self._finish_impl)
        else:
            self._finish_impl()

    def _finish_impl(self) -> None:
        req = self.request
        if self.streaming and req.num_tokens_streamed < req.num_output_tokens:
            tail = req.output_token_ids[req.num_tokens_streamed:]
            req.num_tokens_streamed = req.num_output_tokens
            self._on_tokens(tail)
        out = CompletionOutput(
            index=0,
            token_ids=list(req.output_token_ids),
            cumulative_logprob=req.cum_logprob or None,
            logprobs=req.logprobs or None,
            finish_reason=req.finish_reason.name.lower())
        out.text = self._safe_decode(req.output_token_ids)
        sp = req.sampling_params
        if sp.stop and out.text:
            for stop in sp.stop:
                idx = out.text.find(stop)
                if idx >= 0:
                    end = idx + (len(stop)
                                 if sp.include_stop_str_in_output else 0)
                    out.text = out.text[:end]
                    break
        self.outputs = [out]
        self._done.set()
        if self.streaming:
            self._stream_queue.put(None)

    def _on_error(self, err: Exception) -> None:
        self.error = err
        self._done.set()
        if self.streaming:
            self._stream_queue.put(None)

    def _safe_decode(self, token_ids) -> str:
        if self.tokenizer is None or \
                not self.request.sampling_params.detokenize:
            return ""
        try:
            return self.tokenizer.decode(
                token_ids,
                skip_special_tokens=self.request.sampling_params
                .skip_special_tokens)
        except Exception:  # a tokenizer fault must not kill the loop
            return ""


@dataclasses.dataclass
class _InflightBatch:
    entries: List[LlmRequest]
    samples_output: List[bool]   # row's sampled token is a real output token
    result: HostFuture           # (tokens, logprobs[, top vals, top ids]) or
                                 # multi: (tokens [K, S], logprobs, emitted)
                                 # spec: (tokens [K, S, d+1], logprobs,
                                 # counts [K, S], emitted[, top vals, ids])
    kind: str = "single"         # "single" | "multi" | "spec"
    planned: Optional[List[int]] = None   # multi/spec: per-row budget
    has_top_lp: bool = False
    drafts: Optional[List[List[int]]] = None  # single: each row's drafts
    # single steps with logits processors: (batch rows, their processed
    # logits rows on their way to the host)
    logits_rows: Optional[tuple] = None


@dataclasses.dataclass
class IterationStats:
    """One executor iteration (the JAX executor's ``IterationStats``,
    executor.py:209-221, with its field names; the MoE balancer's fields
    stay None / 0, as for a dense model there)."""
    iter_counter: int = 0
    num_active_requests: int = 0
    num_queued_requests: int = 0
    num_ctx_tokens: int = 0
    num_gen_tokens: int = 0
    kv_cache_free_blocks: int = 0
    iter_latency_ms: float = 0.0
    moe_expert_skew: Optional[float] = None
    moe_rebalances: int = 0


def _host_sample(logits: np.ndarray, sp, step_idx: int):
    """Host-side sampling for the logits-processor path (sync mode only),
    the JAX executor's numpy routine unchanged, so that processor rows
    sample the same token for the same seed."""
    lf = logits.astype(np.float64)
    if sp.greedy:
        tok = int(np.argmax(lf))
    else:
        l = lf / max(sp.temperature, 1e-5)
        if sp.top_k > 0:
            kth = np.partition(l, -sp.top_k)[-sp.top_k]
            l = np.where(l < kth, -np.inf, l)
        if sp.top_p < 1.0:
            order = np.argsort(-l)
            p = np.exp(l[order] - l[order[0]])
            p = p / p.sum()
            keep = np.cumsum(p) - p <= sp.top_p
            mask = np.full_like(l, -np.inf)
            mask[order[keep]] = l[order[keep]]
            l = mask
        p = np.exp(l - np.max(l))
        p = p / p.sum()
        rng = np.random.default_rng(((sp.seed or 0) << 20) ^ step_idx)
        tok = int(rng.choice(len(p), p=p))
    logz = np.logaddexp.reduce(lf)
    return tok, float(lf[tok] - logz)


class PyExecutor:
    def __init__(self,
                 engine: ModelEngine,
                 kv_cache_manager: KVCacheManager,
                 scheduler: RequestScheduler,
                 tokenizer=None,
                 enable_overlap: bool = True,
                 stream_interval: int = 1,
                 pipeline_depth: int = 4,
                 decode_multi_step: int = 1,
                 waiting_queue_policy: str = "fcfs",
                 max_active_requests: Optional[int] = None,
                 decode_wait_occupancy: float = 0.0,
                 ttft_slo_ms: float = 0.0,
                 drafter=None,
                 guided_decoder=None,
                 kv_connector=None,
                 tracer=None,
                 num_postprocess_workers: int = 0):
        self.engine = engine
        # a span per finished request (llmapi/tracing.py RequestTracer)
        self.tracer = tracer
        # detokenization off the loop: streamed chunks and final outputs
        # are built on these threads (the JAX executor.py:256-262)
        self._postproc = ThreadPoolExecutor(
            num_postprocess_workers, thread_name_prefix="tllm-postproc") \
            if num_postprocess_workers > 0 else None
        # an external KV store (runtime/kv_connector.py KvConnectorManager)
        # and the finished requests whose blocks wait for its async save
        self.kv_connector = kv_connector
        self._save_parked: List[LlmRequest] = []
        self.kv = kv_cache_manager
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        # the EAGLE3 head of the fused speculative window (engine.sd), which
        # the executor only feeds acceptance statistics, or a host drafter
        self.drafter = drafter
        self.host_drafter = drafter if engine.sd is None else None
        self.waiting = create_waiting_queue(waiting_queue_policy)
        self.max_active_requests = max_active_requests or \
            4 * engine.max_batch_size
        if self.host_drafter is not None:
            # host drafting needs the host-visible token history one step
            # ahead: the sync scheduler (the JAX executor.py:281-288)
            enable_overlap = False
        # a one-model head on the host path reads every emitted token's
        # (token, pre-norm hidden row) pair (the JAX executor.py:
        # 1719-1726): single steps collect the hidden rows
        self._stream_feats = getattr(self.host_drafter,
                                     "wants_hidden_states", False)
        # guided decoding (guided/): the host backend's matcher must see
        # token t before masking t + 1, so it takes the sync scheduler; the
        # device backend rides the overlap one (the JAX executor.py:274-281)
        self.guided_decoder = guided_decoder
        if guided_decoder is not None and guided_decoder.device is None:
            enable_overlap = False
        self.enable_overlap = enable_overlap
        self.stream_interval = stream_interval
        # decode window: K decode iterations per dispatch; 1 = one-token
        # steps
        self.multi_step = max(1, decode_multi_step)
        # steps in flight before the host consumes results
        self.pipeline_depth = max(1, pipeline_depth) if enable_overlap else 1
        # batching-wait: while context runs and fewer than this share of
        # max_batch_size rows decode, the decode rows sit out
        self.decode_wait_occupancy = decode_wait_occupancy
        # TTFT budget: this iteration's window length, K/4 while someone
        # waits past ttft_slo_ms for a first token
        self.ttft_slo_ms = ttft_slo_ms
        self._iter_K = self.multi_step
        self.ttft_shrunk_iters = 0
        # decode rows dispatched outside spec windows while a drafter is
        # attached (rows that do not qualify, _spec_row_ok), and spec
        # iterations that emitted nothing for any row (a graph runs them)
        self.nonspec_decode_rows = 0
        self.spec_idle_iters = 0
        # host drafting: decode rows verified with drafts, drafts they
        # carried and drafts accepted (after discarding past a stop)
        self.drafted_rows = 0
        self.drafts_proposed = 0
        self.drafts_accepted = 0
        # beam groups by parent request id (runtime/beam_search.py), and
        # the rows that took another row's beam
        self._beam_groups: Dict[int, "BeamGroup"] = {}
        self.beam_forks = 0
        # requests whose prompt_logprobs this thread computes when it takes
        # them, and the teacher-forced forwards' count and wall time
        self._prompt_lp_queue: "queue.Queue" = queue.Queue()
        self.prompt_logprob_forwards = 0
        self.prompt_logprob_ms = 0.0
        # guided decoding: admissions of guided requests and their wall
        # time (a grammar's first admission compiles it; on the device
        # backend it also builds the token DFA and lands the segment), and
        # admissions deferred because the pool was full
        self.guided_admissions = 0
        self.guided_admission_ms = 0.0
        self.guided_deferred = 0
        # supervision (runtime/error_isolation.py, hang_detector.py): the
        # fatal-promotion budget, the requests of the iteration being
        # dispatched, requests failed alone, and the watchdog
        self.error_budget = ErrorBudget()
        self._iter_requests: List[LlmRequest] = []
        self.requests_failed = 0
        self._hang_detector = HangDetector(timeout_s=600.0)
        self._hang_detector.start()
        # iteration statistics (``LLM.get_stats``), the last 1,000
        self.iter_counter = 0
        self.stats_history: List[IterationStats] = []

        self._request_queue: "queue.Queue" = queue.Queue()
        self._results: Dict[int, GenerationResult] = {}
        self._active: List[LlmRequest] = []
        self._free_slots = list(range(engine.max_batch_size - 1, -1, -1))
        self._inflight: "deque[_InflightBatch]" = deque()
        self._shutdown = threading.Event()
        self._work_event = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._executor_loop,
                                        daemon=True, name="tllm-executor")
        self._thread.start()

    # ------------------------------------------------------------------ #
    # API
    # ------------------------------------------------------------------ #
    def has_open_requests(self) -> bool:
        """Whether a submitted request has not finished yet."""
        with self._lock:
            return any(not r.finished for r in self._results.values())

    def submit(self, request: LlmRequest) -> GenerationResult:
        """Queue a request, with the JAX executor's checks
        (executor.py:404-445): a logits processor and beam search need
        the sync scheduler; no-repeat-ngram takes neither beams nor a
        processor, and at most ``NGRAM_MAX`` tokens."""
        if self._shutdown.is_set():
            raise RuntimeError("executor is shut down")
        sp = request.sampling_params
        if sp.guided_decoding is not None:
            self._check_guided(sp)
        if sp.logits_processor is not None and self.enable_overlap:
            raise ValueError(
                "logits_processor needs the sync scheduler: build the LLM "
                "with disable_overlap_scheduler=True (reference gates "
                "per-request processors the same way)")
        if sp.no_repeat_ngram_size > 0:
            if sp.use_beam_search:
                raise ValueError(
                    "no_repeat_ngram_size is not supported with beam "
                    "search")
            if sp.logits_processor is not None:
                raise ValueError(
                    "no_repeat_ngram_size cannot combine with a "
                    "logits_processor (the in-graph history would record "
                    "the pre-processor sample)")
            if sp.no_repeat_ngram_size > NGRAM_MAX:
                raise ValueError(
                    f"no_repeat_ngram_size must be <= {NGRAM_MAX}")
        if sp.use_beam_search and self.enable_overlap:
            raise ValueError(
                "beam search needs the sync scheduler: build the LLM "
                "with disable_overlap_scheduler=True (or max_beam_width"
                " > 1, which implies it)")
        res = GenerationResult(request, tokenizer=self.tokenizer,
                               streaming=request.streaming,
                               postproc_pool=self._postproc)
        with self._lock:
            self._results[request.request_id] = res
        if sp.prompt_logprobs is not None:
            self._prompt_lp_queue.put(request)
        if sp.use_beam_search:
            rows = make_beam_rows(request)
            with self._lock:
                self._beam_groups[request.request_id] = BeamGroup(request,
                                                                  rows)
            for row in rows:
                self._request_queue.put(row)
        else:
            self._request_queue.put(request)
        self._work_event.set()
        return res

    def _check_guided(self, sp) -> None:
        """Refuse, by name, what guided decoding is not served with: no
        guided backend on this LLM (the JAX package ignores the
        constraint silently there, having no decoder), speculative
        decoding (the JAX package gives device-guided rows of a verify
        step neither the walk nor a mask) and beam search (the JAX
        package forks beams without their grammar state)."""
        if self.guided_decoder is None:
            raise ValueError(
                "guided_decoding needs a guided backend: build the LLM with "
                "guided_decoding_backend=\"dfa\" (the device walk) or "
                "\"dfa-host\"")
        if self.drafter is not None:
            raise NotImplementedError(
                "guided decoding with speculative decoding "
                "(speculative_config) is not supported by this package yet")
        if sp.use_beam_search:
            raise NotImplementedError(
                "guided decoding with beam search is not supported by this "
                "package yet")

    def cancel(self, request_id: int) -> None:
        """End a request: it finishes CANCELLED at the next iteration
        (``_reap_finished``), or at admission while it is still queued."""
        with self._lock:
            res = self._results.get(request_id)
        if res is not None:
            res.request.cancel()
            self._work_event.set()

    def shutdown(self, wait: bool = True) -> None:
        self._shutdown.set()
        self._hang_detector.stop()
        self._work_event.set()
        if wait and self._thread.is_alive():
            self._thread.join(timeout=60)
        if self.kv_connector is not None:
            self.kv_connector.shutdown()
        if self._postproc is not None:
            # queued chunks and outputs still run; nothing waits for them
            self._postproc.shutdown(wait=False)
        if self.tracer is not None and self.tracer.exporter is not None:
            # the spans still buffered are posted now, not dropped
            self.tracer.exporter.shutdown()

    # ------------------------------------------------------------------ #
    # Main loop
    # ------------------------------------------------------------------ #
    def _executor_loop(self):
        """Loop supervisor (the JAX executor.py:482-523): a
        ``RequestError`` fails its request alone; any other exception
        fails the requests of the iteration it hit and those whose
        in-flight results it drops (the JAX executor fails the former
        only, though it drops the latter's results too), and the loop
        goes on, unless the error budget says the error is fatal, or
        nothing was implicated: then every open request fails."""
        while True:
            try:
                self._executor_loop_body()
                return
            except RequestError as e:
                fatal = self.error_budget.consume(str(e.cause))
                self._abort_request(e.request, e)
                if fatal:
                    self._die(e)
                    return
                logger.error("request %s failed at %s; budget %.2f: loop "
                             "continues", e.request.request_id, e.stage,
                             self.error_budget.budget)
            except Exception as e:
                traceback.print_exc()
                fatal = self.error_budget.consume(str(e))
                culprits = list(self._iter_requests)
                for ib in self._inflight:
                    culprits += [r for r in ib.entries if r not in culprits]
                culprits = [r for r in culprits if not r.is_finished]
                self._inflight.clear()
                self._iter_requests = []
                for r in culprits:
                    self._abort_request(r, e)
                if fatal or not culprits:
                    self._die(e)
                    return
                logger.error("executor iteration failed (%s); failed %d "
                             "implicated request(s), budget %.2f: loop "
                             "continues", e, len(culprits),
                             self.error_budget.budget)

    def _abort_request(self, req: LlmRequest, exc: Exception) -> None:
        """Fail one request and release its KV and slot; the loop lives
        (the JAX executor.py:542-560)."""
        if not req.is_finished:
            req.finish_by_reason(FinishReason.ERROR)
        self.requests_failed += 1
        for fn in (lambda: self.kv.free_resources(req),
                   lambda: self._release_slot(req)
                   if req.seq_slot is not None else None,
                   lambda: self.guided_decoder.drop(req.request_id)
                   if self.guided_decoder is not None else None):
            try:
                fn()
            except Exception:  # release is best-effort
                logger.error("request %d: release after failure raised",
                             req.request_id)
        if req in self._active:
            self._active.remove(req)
        with self._lock:
            res = self._results.pop(req.request_id, None)
        if res is not None:
            res._on_error(exc)

    def _die(self, e: Exception) -> None:
        logger.error("executor loop died: %s", e)
        self._hang_detector.disarm()
        with self._lock:
            results = list(self._results.values())
        for r in results:
            if not r.finished:
                r._on_error(e)

    def _executor_loop_body(self):
        while not self._shutdown.is_set():
            self._iter_requests = []
            if not self._active and not self._inflight:
                self._work_event.wait(timeout=0.05)
                self._work_event.clear()
            self._fetch_new_requests()
            self._reap_finished()
            if not self._active and not self._inflight:
                self._hang_detector.disarm()
                continue
            self._hang_detector.arm()
            t0 = time.monotonic()
            batch = self._batching_wait(
                self.scheduler.schedule(self._schedulable()))
            # the requests this iteration's dispatch implicates, should it
            # raise (error isolation)
            self._iter_requests = list(batch.all_requests)
            if batch.paused_requests:
                self._pause_requests(batch.paused_requests, batch)
            # TTFT budget: shrink the window while a request has waited
            # past the budget for its first token
            self._iter_K = self.multi_step
            if self.ttft_slo_ms > 0 and self._ttft_urgent():
                self._iter_K = max(1, self.multi_step // 4)
                self.ttft_shrunk_iters += 1
            # decode batches with rows that qualify for the fused
            # speculative window and rows that do not: the qualifying rows
            # split off into their own window, so one row does not demote
            # everyone else's speculation
            spec_side = None
            if (self.engine.sd is not None and not batch.context_requests
                    and batch.generation_requests):
                elig = [r for r in batch.generation_requests
                        if self._spec_row_ok(r)]
                if elig and len(elig) < len(batch.generation_requests):
                    rest = [r for r in batch.generation_requests
                            if not self._spec_row_ok(r)]
                    spec_side = ScheduledRequests(generation_requests=elig)
                    batch = ScheduledRequests(generation_requests=rest)
            # window kind of a pure-decode batch: "spec" (fused speculative
            # window), "multi" (K-step window) or None (one step); a mixed
            # ctx+gen batch splits into a prefill step plus a window of
            # its generation rows
            wkind = None
            if not batch.is_empty and not batch.context_requests:
                if self._spec_window_ok(batch.generation_requests):
                    wkind = "spec"
                elif self._multi_step_ok(batch):
                    wkind = "multi"
            multi = wkind is not None
            gen_window = None
            gwkind = None
            if (not multi and batch.context_requests
                    and batch.generation_requests):
                if self._spec_window_ok(batch.generation_requests):
                    gwkind = "spec"
                elif self.multi_step > 1 and \
                        self._multi_rows_ok(batch.generation_requests):
                    gwkind = "multi"
                if gwkind is not None:
                    gen_window = ScheduledRequests(
                        generation_requests=batch.generation_requests)
                    batch = ScheduledRequests(
                        context_requests=batch.context_requests)
            if spec_side is not None:
                self._prepare_resources_spec(spec_side)
                if spec_side.generation_requests:
                    self._dispatch_spec(spec_side)
            if not batch.is_empty or gen_window is not None:
                if self.host_drafter is not None and not multi:
                    self._prepare_drafts(batch)
                if wkind == "spec":
                    self._prepare_resources_spec(batch)
                elif multi:
                    self._prepare_resources_multi(batch)
                else:
                    self._prepare_resources(batch)
                if gen_window is not None:
                    if gwkind == "spec":
                        self._prepare_resources_spec(gen_window)
                    else:
                        self._prepare_resources_multi(gen_window)
                if self.kv_connector is not None:
                    # connector metadata out, and external KV into the
                    # pages just allocated, before the forward (the JAX
                    # executor.py:705-708)
                    self.kv_connector.begin_batch()
            # mixed window: resourced context chunks ride inside the
            # decode window's steps, where their prefill hides under the
            # decode steps' weight reads; they leave the prefill step
            riders: List[LlmRequest] = []
            if (gen_window is not None and gwkind == "multi"
                    and gen_window.generation_requests
                    and batch.context_requests and self._mixed_ok()):
                cap = self.engine.mixed_ctx_tokens * self._iter_K
                tot = 0
                for r in batch.context_requests:
                    if tot >= cap:
                        break
                    if self._ctx_rider_ok(r):
                        riders.append(r)
                        tot += min(r.context_chunk_size,
                                   r.context_remaining_length)
                if riders:
                    batch = ScheduledRequests(context_requests=[
                        r for r in batch.context_requests
                        if r not in riders])
            if batch.is_empty and gen_window is None:
                self._process_inflight()     # nothing runnable; drain
                continue
            wb = batch if multi else gen_window
            if wb is not None and wb.generation_requests:
                if (wkind if multi else gwkind) == "spec":
                    self._dispatch_spec(wb)
                else:
                    self._dispatch_multi(wb, riders)
            if not multi and not batch.is_empty:
                use_pen = any(r.sampling_params.needs_penalties
                              for r in batch.all_requests)
                seed = self._spec_seed_rows(batch)
                if self.engine.sd is not None:
                    self.nonspec_decode_rows += len(batch.generation_requests)
                use_proc = any(r.sampling_params.logits_processor is not None
                               for r in batch.all_requests)
                mask = self.guided_decoder.build_mask(batch) \
                    if self.guided_decoder is not None else None
                outs = self.engine.forward_step(
                    batch, use_penalties=use_pen,
                    collect_hidden=bool(seed[0]) or self._stream_feats,
                    bad_ids=self._apply_bad_words(batch),
                    collect_logits=use_proc, logits_mask=mask)
                logits_rows = None
                if use_proc:
                    rows, logits = self.engine._last_logits_rows
                    logits_rows = (rows, HostFuture(logits))
                if seed[0]:
                    # the draft head's pending pair, on the device
                    self.engine.spec_seed(outs[0], outs[-1], *seed)
                    outs = outs[:-1]
                elif self._stream_feats:
                    # the host path's features, float32 to the host
                    outs = outs[:-1] + (outs[-1].float(),)
                entries, samples, drafts = self._advance_device_state(batch)
                self._inflight.append(_InflightBatch(
                    entries, samples, HostFuture(*outs),
                    has_top_lp=len(outs) > 2 + self._stream_feats,
                    drafts=drafts, logits_rows=logits_rows))
            while len(self._inflight) >= self.pipeline_depth:
                self._process_inflight()
            self._record_stats(batch, time.monotonic() - t0, gen_window)
        # drain at shutdown
        while self._inflight:
            self._process_inflight()

    def _record_stats(self, batch: ScheduledRequests, latency: float,
                      extra: Optional[ScheduledRequests] = None) -> None:
        """One ``IterationStats`` (the JAX executor.py:2072-2093)."""
        self.iter_counter += 1
        ngen = len(batch.generation_requests) + \
            (len(extra.generation_requests) if extra is not None else 0)
        self.stats_history.append(IterationStats(
            iter_counter=self.iter_counter,
            num_active_requests=len(self._active),
            num_queued_requests=self._request_queue.qsize(),
            num_ctx_tokens=sum(min(r.context_chunk_size, r.prompt_len)
                               for r in batch.context_requests),
            num_gen_tokens=ngen,
            kv_cache_free_blocks=self.kv.get_num_free_blocks(),
            iter_latency_ms=latency * 1e3))
        if len(self.stats_history) > 1000:
            self.stats_history.pop(0)

    def _dispatch_multi(self, wb: ScheduledRequests,
                        riders: List[LlmRequest]) -> None:
        use_pen = any(r.sampling_params.needs_penalties
                      for r in wb.all_requests)
        tokens, logprobs, emitted, carved = self.engine.forward_multi_step(
            wb, self._iter_K, use_penalties=use_pen, ctx_requests=riders)
        self._advance_ctx_riders(riders, carved)
        entries, planned = self._advance_multi(wb)
        self._inflight.append(_InflightBatch(
            entries, [True] * len(entries),
            HostFuture(tokens, logprobs, emitted), kind="multi",
            planned=planned))

    def _dispatch_spec(self, wb: ScheduledRequests) -> None:
        outs = self.engine.forward_spec_window(wb)
        entries, planned = self._advance_spec(wb)
        self._inflight.append(_InflightBatch(
            entries, [True] * len(entries), HostFuture(*outs), kind="spec",
            planned=planned, has_top_lp=len(outs) > 4))

    def _spec_seed_rows(self, batch: ScheduledRequests):
        """(batch rows, slots, positions, emitted counts) of the context
        rows whose last chunk this step runs: their sampled token and its
        feature seed the draft head (``spec_seed``). Only context rows
        seed: a generation row on this path was disqualified from spec
        windows for reasons that do not change."""
        rows, slots, positions, emitted = [], [], [], []
        if self.engine.sd is None:
            return rows, slots, positions, emitted
        for i, r in enumerate(batch.context_requests):
            if not r.is_last_context_chunk or r.seq_slot is None:
                continue
            rows.append(i)
            slots.append(r.seq_slot)
            positions.append(r.context_len)
            emitted.append(r.context_len - r.prompt_len + 1)
            r.spec_seeded = True
        return rows, slots, positions, emitted

    def _batching_wait(self, batch: ScheduledRequests) -> ScheduledRequests:
        """While context work is scheduled and the decode pool is under
        the occupancy target, decode rows sit out this iteration, so
        prefill refills the pool and windows run full. Rows only wait
        while context runs."""
        if (self.decode_wait_occupancy > 0 and batch.context_requests
                and batch.generation_requests
                and len(batch.generation_requests) <
                self.decode_wait_occupancy * self.engine.max_batch_size):
            return ScheduledRequests(context_requests=batch.context_requests,
                                     paused_requests=batch.paused_requests)
        return batch

    def _ttft_urgent(self) -> bool:
        """True when any request that has not produced its first token
        has waited past the TTFT budget (llm_args.ttft_slo_ms)."""
        budget = self.ttft_slo_ms / 1e3
        now = time.monotonic()
        for req in self.waiting:
            if now - req.perf.arrival_time > budget:
                return True
        for req in self._active:
            p = req.perf
            if not p.first_token_time and now - p.arrival_time > budget:
                return True
        return False

    # ------------------------------------------------------------------ #
    def _fetch_new_requests(self):
        while True:
            try:
                req = self._prompt_lp_queue.get_nowait()
            except queue.Empty:
                break
            if req.is_finished:
                continue              # cancelled before it was taken
            try:
                self._prompt_logprobs(req)
            except Exception as e:
                # its own forward: this request alone fails (it is still
                # queued, so the waiting queue drops it at admission)
                req.finish_by_reason(FinishReason.ERROR)
                raise RequestError(req, "prompt_logprobs", e) from e
        while True:
            try:
                req = self._request_queue.get_nowait()
            except queue.Empty:
                break
            self.waiting.add_request(req)
        # admission: waiting -> active while there is room; a request
        # cancelled (or failed) in the queue finishes here
        while self.waiting and len(self._active) < self.max_active_requests:
            req = self.waiting.pop_request()
            if req.is_finished:
                self._finish_request(req)
                continue
            self._active.append(req)

    def _reap_finished(self) -> None:
        """Complete the requests finished out of band (cancellation; the
        JAX executor.py:1927-1931), and free the KV of requests whose
        connector save landed."""
        for req in [r for r in self._active if r.is_finished]:
            self._finish_request(req)
        if self.kv_connector is not None and self._save_parked:
            for req in self.kv_connector.poll_finished_saves():
                self.kv.free_resources(req)
                if req.seq_slot is not None:
                    self._release_slot(req)
                if req in self._save_parked:
                    self._save_parked.remove(req)

    def _prompt_logprobs(self, req: LlmRequest) -> None:
        """The request's ``prompt_logprobs``: one teacher-forced forward
        over its prompt in a pool of its own (evaluate/perplexity.py),
        run here on the executor thread, before the request is scheduled
        (the JAX ``LLM.generate_async`` runs it on the caller's thread)."""
        from ..evaluate.perplexity import prompt_logprob_dicts
        t0 = time.perf_counter()
        req.prompt_logprobs_result = prompt_logprob_dicts(
            self.engine.model, self.engine.params, req.prompt_token_ids,
            top_k=int(req.sampling_params.prompt_logprobs))
        self.prompt_logprob_ms += (time.perf_counter() - t0) * 1e3
        self.prompt_logprob_forwards += 1

    def _beam_held(self) -> set:
        """Ids of beam rows that sit out this iteration, so that a group's
        rows step together: a group starts only when the free slots, less
        those that partly started groups still need, hold all its rows,
        and a group's decode rows wait while any of its rows is still in
        its context phase. (The JAX executor admits beam rows one by one,
        so a group wider than the free slots can start some rows while the
        rest wait behind them.)"""
        held: set = set()
        free = len(self._free_slots)
        fresh = []
        for group in self._beam_groups.values():
            waiting = [r for r in group.rows if r.seq_slot is None]
            if len(waiting) == group.width:
                fresh.append(group)
                continue
            free -= len(waiting)
            if any(r.is_context_init_state for r in group.rows):
                held.update(r.request_id for r in group.rows
                            if not r.is_context_init_state)
        for group in fresh:
            if free >= group.width:
                free -= group.width
            else:
                held.update(r.request_id for r in group.rows)
        return held

    def _schedulable(self) -> List[LlmRequest]:
        out = []
        held = self._beam_held() if self._beam_groups else ()
        for r in self._active:
            if r.is_finished or r.request_id in held:
                continue
            if r.is_generation_in_progress and not r.is_context_init_state:
                # length gate on device progress (overlap runs ahead)
                if r.num_device_tokens - r.prompt_len + 1 >= \
                        r.sampling_params.max_tokens:
                    continue
            if r.is_generation_in_progress and r.seq_slot is None:
                continue
            out.append(r)
        return out

    def _pause_requests(self, paused: List[LlmRequest],
                        batch: ScheduledRequests) -> None:
        """MAX_UTILIZATION eviction: drain the pipeline, release the
        paused requests' KV into the reuse tree and reset them to
        CONTEXT_INIT for recompute-on-resume."""
        while self._inflight:
            self._process_inflight()
        for req in paused:
            if req.is_finished:
                continue
            logger.info("pausing request %d under memory pressure "
                        "(%d tokens recompute on resume)",
                        req.request_id, req.num_total_tokens)
            self.kv.free_resources(req, store_for_reuse=True)
            if req.seq_slot is not None:
                self._release_slot(req)
            req.pause_for_recompute()
            if req in batch.generation_requests:
                batch.generation_requests.remove(req)
            if req in batch.context_requests:
                batch.context_requests.remove(req)

    def _prepare_resources(self, batch: ScheduledRequests):
        """KV allocation + slot assignment."""
        deferred = []
        new_slots = []
        for req in batch.context_requests:
            if req.seq_slot is None:
                if not self._free_slots:
                    # slots release one iteration after a request finishes
                    # (overlap lag); defer admission to the next iteration
                    deferred.append(req)
                    continue
                req.seq_slot = self._free_slots.pop()
                try:
                    reused = self.kv.add_sequence(req)
                except NoFreeBlocksError:
                    self._free_slots.append(req.seq_slot)
                    req.seq_slot = None
                    deferred.append(req)
                    continue
                if req.sampling_params.guided_decoding is not None and \
                        not self._admit_guided(req):
                    if req.seq_slot is not None:      # deferred, not failed
                        self.kv.free_resources(req, store_for_reuse=False)
                        self._free_slots.append(req.seq_slot)
                        req.seq_slot = None
                    deferred.append(req)
                    continue
                new_slots.append(req.seq_slot)
                if self.engine._mrope:
                    # the windows rotate the slot's rows at pos + delta
                    self.engine.set_mrope_delta(req.seq_slot,
                                                req.mrope_delta)
                if self.engine._cross:
                    # Mllama: the request's vision K/V into its slot, or
                    # a text-only request clears the recycled slot's. The
                    # states stay on the request until it finishes, so a
                    # request paused under MAX_UTILIZATION writes them
                    # into its new slot again (the JAX executor.py:
                    # 1127-1135 drops them here, and such a request
                    # decodes the rest of its output as text)
                    if req.cross_states is not None:
                        self.engine.set_cross_state(req.seq_slot,
                                                    req.cross_states)
                    else:
                        self.engine.clear_cross_state(req.seq_slot)
                sp = req.sampling_params
                if sp.no_repeat_ngram_size > 0:
                    # seed the slot's token history with the context
                    self.engine.write_history(req.seq_slot,
                                              req.context_token_ids)
                if sp.embedding_bias is not None or \
                        self.engine.bias_pool is not None:
                    # None clears a recycled slot's bias
                    self.engine.set_embedding_bias(req.seq_slot,
                                                   sp.embedding_bias)
                if reused:
                    req.context_current_position = reused
                    req.perf.kv_cache_hit_tokens = reused
                if self.kv_connector is not None:
                    # the external store may extend the reused prefix, by
                    # whole blocks and never to the last prompt token (the
                    # JAX executor.py:1141-1150)
                    extra = self.kv_connector.query_match(req, reused)
                    extra = min(extra, req.context_len - 1 - reused)
                    extra -= extra % self.kv.tokens_per_block
                    if extra > 0:
                        req.context_current_position = reused + extra
                        req.perf.kv_cache_hit_tokens = reused + extra
                    self.kv_connector.after_alloc(req, extra)
                if req.perf.first_scheduled_time == 0:
                    req.perf.first_scheduled_time = time.monotonic()
        for req in deferred:
            batch.context_requests.remove(req)
        self.engine.reset_slot_counts(new_slots)
        starved = []
        for req in batch.generation_requests:
            try:
                self.kv.add_token(req)
                if req.draft_tokens:
                    self.kv.add_draft_tokens(req, len(req.draft_tokens))
            except NoFreeBlocksError:
                starved.append(req)
        for req in starved:
            req.draft_tokens = []
            batch.generation_requests.remove(req)

    def _admit_guided(self, req: LlmRequest) -> bool:
        """Compile the request's grammar as it takes its slot (cached per
        grammar); on the device backend also land its segment in the pool
        and set the slot's state, past the tokens it already has when it
        resumes (``on_slot_assigned``). False: the request does not run
        now, either deferred (the pool is full) or failed alone (a
        grammar that does not compile or can never fit the pool; the JAX
        executor.py:1097-1113)."""
        from ..guided.device_guided import NoPoolSpaceError
        t0 = time.perf_counter()
        try:
            if self.guided_decoder.device is not None:
                self.guided_decoder.on_slot_assigned(req, self.engine)
            else:
                self.guided_decoder.factory.compile_dfa(
                    req.sampling_params.guided_decoding)
        except NoPoolSpaceError:
            self.guided_deferred += 1
            return False
        except Exception as e:
            # the request's own fault: no draw on the loop's error budget
            self._abort_request(req, e)
            return False
        finally:
            self.guided_admissions += 1
            self.guided_admission_ms += (time.perf_counter() - t0) * 1e3
        return True

    def _prepare_drafts(self, batch: ScheduledRequests) -> None:
        """Draft proposal for the decode rows (the JAX executor.py:
        1572-1601): rows without penalties (the penalty counts cannot
        advance mid-step), a logits processor or beams are draftable;
        each row keeps at most its
        remaining tokens less one, its room in ``max_seq_len`` and
        ``max_draft_len`` drafts. The scheduler counted one token per
        decode row, so drafts are also cut, in row order, to the tokens
        the step's largest bucket has left (the JAX engine raises past
        it instead)."""
        def draftable(r):
            sp = r.sampling_params
            return not (sp.needs_penalties or r.is_beam_row
                        or sp.logits_processor is not None
                        or sp.guided_decoding is not None)
        gen = [r for r in batch.generation_requests if draftable(r)]
        self.host_drafter.prepare_draft_tokens(gen)
        left = self.engine.token_buckets[-1] - len(batch.generation_requests)
        for r in batch.context_requests:
            left -= min(r.context_len - r.context_current_position,
                        r.context_chunk_size)
        for req in batch.generation_requests:
            if not draftable(req):
                req.draft_tokens = []
                continue
            if req.draft_parents is not None:
                raise NotImplementedError(
                    "tree drafts (a drafter that sets draft_parents) are "
                    "not supported by this package yet")
            remaining = req.sampling_params.max_tokens - \
                req.num_output_tokens - 1
            room = self.engine.max_seq_len - (req.num_device_tokens + 1)
            cap = max(0, min(remaining, room, self.engine.max_draft_len,
                             left))
            req.draft_tokens = list(req.draft_tokens)[:cap]
            left -= len(req.draft_tokens)

    # ------------------------------------------------------------------ #
    # Multi-step decode window (K tokens per dispatch)
    # ------------------------------------------------------------------ #
    def _multi_step_ok(self, batch: ScheduledRequests) -> bool:
        """A pure-decode batch takes the K-step window unless a row needs
        a per-token host look (top-k logprobs, bad words, a logits
        processor, beams, too many stop ids; the JAX _multi_rows_ok,
        executor.py:1190-1205). No-repeat-ngram and embedding-bias rows
        stay: the window carries their history and bias on the device."""
        if self.multi_step <= 1 or batch.context_requests:
            return False
        return self._multi_rows_ok(batch.generation_requests)

    def _multi_rows_ok(self, gen_requests) -> bool:
        """Rows of the host guided backend leave windows (their matcher
        must see each token); device-guided rows ride them."""
        if self.drafter is not None:
            return False
        for r in gen_requests:
            sp = r.sampling_params
            if (sp.logprobs or sp.bad_token_ids or sp.use_beam_search
                    or r.is_beam_row or sp.logits_processor is not None
                    or r.lora_task_id is not None
                    or len(sp.stop_id_list()) > self.engine.NSTOP
                    or (sp.guided_decoding is not None
                        and not r.guided_device)):
                return False
        return True

    def _prepare_resources_multi(self, batch: ScheduledRequests) -> None:
        """Pre-allocate KV pages for each request's decode window and set
        its per-window token budget."""
        K = self._iter_K
        starved = []
        for req in batch.generation_requests:
            sp = req.sampling_params
            ndt = req.num_device_tokens
            # max(0, .): a rider-flipped row sits one position BEFORE its
            # first output (it recomputes the last prompt token)
            outs = max(0, ndt - req.prompt_len)
            budget = max(1, min(K, sp.max_tokens - outs,
                                self.engine.max_seq_len - ndt))
            try:
                self.kv.add_tokens(req, budget)
                req.multi_step_budget = budget
            except NoFreeBlocksError:
                # admitted on a one-token need: degrade to a single step
                try:
                    self.kv.add_token(req)
                    req.multi_step_budget = 1
                except NoFreeBlocksError:
                    starved.append(req)
        for req in starved:
            batch.generation_requests.remove(req)

    # ------------------------------------------------------------------ #
    # Mixed windows: context riders
    # ------------------------------------------------------------------ #
    def _mixed_ok(self) -> bool:
        """Rider windows are on (``mixed_window_ctx`` > 0), the engine
        has one KV pool (not VSWA) and no M-RoPE, image-group or
        cross-attention model, as in the JAX package (executor.py:1214).
        The K-step window itself stays on for all of them."""
        return self.engine.riders_ok

    def _ctx_rider_ok(self, r: LlmRequest) -> bool:
        """A context request can ride once it holds a slot and its KV,
        unless it carries prompt embeddings or an adapter: a window takes
        token ids only and applies no adapter, so such a request stays in
        the prefill step (the JAX executor.py:1217-1223; the
        cross-attention model's requests never meet a rider window,
        ``_mixed_ok``)."""
        return r.seq_slot is not None and r.prompt_embeds is None \
            and r.lora_task_id is None

    def _advance_ctx_riders(self, riders: List[LlmRequest],
                            carved: List[int]) -> None:
        """Host bookkeeping after a mixed window: carved context wrote
        its KV in-window. A fully-prefilled prompt flips straight to
        generation with the LAST prompt token as the next step's input
        (its KV rewrite is idempotent), so the first output samples
        through the normal gen path without a separate prefill step."""
        for r, c in zip(riders, carved):
            if c <= 0:
                continue
            r.context_current_position += c
            if r.context_current_position >= r.context_len:
                r.state = LlmRequestState.GENERATION_IN_PROGRESS
                r.num_device_tokens = r.context_len - 1
                r.host_token_override = int(r.context_token_ids[-1])

    def _advance_multi(self, batch: ScheduledRequests):
        entries, planned = [], []
        for req in batch.generation_requests:
            req.num_device_tokens += req.multi_step_budget
            req.host_token_override = None
            entries.append(req)
            planned.append(req.multi_step_budget)
        return entries, planned

    def _process_multi(self, batch: _InflightBatch) -> None:
        tokens, logprobs, emitted = batch.result.get()
        tok_cols = tokens.T          # [Sb, K]
        lp_cols = logprobs.T
        finished: List[LlmRequest] = []
        for i, req in enumerate(batch.entries):
            if req.is_finished:
                continue
            e = int(emitted[i])
            plan = batch.planned[i]
            sp = req.sampling_params
            if (e == plan and e > 0 and not sp.stop_token_ids
                    and (sp.end_id is None or sp.ignore_eos)
                    and not (sp.stop and self.tokenizer is not None)):
                # fast path: no stop ids / stop strings — the window can
                # only end by length. Bulk-append the whole emitted run.
                now = time.monotonic()
                if not req.output_token_ids:
                    req.perf.first_token_time = now
                req.perf.last_token_time = now
                # the window budget is KV-room capped, not length capped:
                # truncate at max_tokens and roll the device accounting
                # back (clamped at 0: never append a negative count)
                take = max(0, min(e, sp.max_tokens - req.num_output_tokens))
                row_t = tok_cols[i, :take].tolist()
                row_l = lp_cols[i, :take].tolist()
                req.output_token_ids.extend(row_t)
                req.cum_logprob += sum(row_l)
                req.logprobs.extend({t: l} for t, l in zip(row_t, row_l))
                if take < plan:
                    req.num_device_tokens -= plan - take
                if req.num_output_tokens >= sp.max_tokens:
                    req.finish_by_reason(FinishReason.LENGTH)
                    finished.append(req)
                else:
                    self._stream(req)
                continue
            accepted = 0
            done = False
            check_stop_strings = bool(sp.stop) and self.tokenizer is not None
            for j in range(e):
                done = req.add_output_token(int(tokens[j, i]),
                                            float(logprobs[j, i]))
                accepted += 1
                if not done and check_stop_strings:
                    done = self._check_stop_strings(req)
                if done:
                    break
            if accepted < plan:
                # the device stopped early (or a stop string landed
                # mid-window): roll host bookkeeping back to the accepted
                # prefix so the KV accounting matches
                req.num_device_tokens -= plan - accepted
                if not done:
                    logger.warning(
                        "request %d: device emitted %d of %d planned "
                        "tokens without a host-visible stop",
                        req.request_id, e, plan)
            if done:
                finished.append(req)
            else:
                self._stream(req)
        for req in finished:
            self._finish_request(req)

    # ------------------------------------------------------------------ #
    # Fused speculative window (runtime/spec_window.py)
    # ------------------------------------------------------------------ #
    def _spec_window_ok(self, gen_requests) -> bool:
        """Rows may take the fused propose/verify/accept window when every
        one qualifies (``_spec_row_ok``)."""
        if self.engine.sd is None or not gen_requests:
            return False
        return all(self._spec_row_ok(r) for r in gen_requests)

    def _spec_row_ok(self, r: LlmRequest) -> bool:
        """Greedy and sampled rows qualify (seeded rows accept by
        position-keyed sample-and-match, unseeded ones by rejection
        sampling), top-k logprobs included, once a prefill step of this
        engine seeded the row and while it has room. Rows with penalties
        (no-repeat-ngram among them), bad words, an embedding bias, a
        logits processor, beams, a grammar or an adapter, and rows with
        more stop ids than the window checks do not (the JAX
        executor.py:1385-1405)."""
        sp = r.sampling_params
        if (sp.needs_penalties or sp.bad_token_ids
                or r.lora_task_id is not None
                or sp.guided_decoding is not None
                or sp.embedding_bias is not None
                or sp.logits_processor is not None
                or sp.use_beam_search or r.is_beam_row
                or len(sp.stop_id_list()) > self.engine.NSTOP
                or not r.spec_seeded):
            return False
        outs = r.num_device_tokens - r.prompt_len
        room = self.engine.max_seq_len - r.num_device_tokens - \
            self.engine.sd.d
        return min(sp.max_tokens - outs, room) >= 1

    def _prepare_resources_spec(self, batch: ScheduledRequests) -> None:
        """KV pre-allocation for the fused window: the emission budget
        plus d slots of draft overshoot (the verify pass writes d+1
        positions per iteration; rejected-draft KV is overwritten by the
        next iteration's writes, never rewound)."""
        sd = self.engine.sd
        W = sd.K * (sd.d + 1)
        starved = []
        for req in batch.generation_requests:
            sp = req.sampling_params
            ndt = req.num_device_tokens
            outs = ndt - req.prompt_len
            budget = max(1, min(W, sp.max_tokens - outs,
                                self.engine.max_seq_len - ndt - sd.d))
            try:
                self.kv.add_tokens(req, budget + sd.d)
                req.spec_budget = budget
            except NoFreeBlocksError:
                try:
                    self.kv.add_tokens(req, 1 + sd.d)
                    req.spec_budget = 1
                except NoFreeBlocksError:
                    starved.append(req)
        for req in starved:
            batch.generation_requests.remove(req)

    def _advance_spec(self, batch: ScheduledRequests):
        entries, planned = [], []
        for req in batch.generation_requests:
            req.num_device_tokens += req.spec_budget
            req.host_token_override = None
            entries.append(req)
            planned.append(req.spec_budget)
        return entries, planned

    def _process_spec(self, ib: _InflightBatch) -> None:
        fetched = ib.result.get()
        tokens, logprobs, counts = fetched[:3]   # [K, Sb, d+1], [K, Sb]
        top_lp = fetched[4:] if ib.has_top_lp else None
        K, _, Dp = tokens.shape
        self.spec_idle_iters += int((counts.sum(axis=1) == 0).sum())
        finished: List[LlmRequest] = []
        for i, req in enumerate(ib.entries):
            if req.is_finished:
                continue
            plan = ib.planned[i]
            sp = req.sampling_params
            cs = counts[:, i]
            if self.drafter is not None:
                # acceptance stats: ck - 1 drafts accepted + 1 bonus
                for ck in cs[cs > 0].tolist():
                    self.drafter.update(req, [0] * (ck - 1))
            if (top_lp is None and not sp.stop_token_ids
                    and (sp.end_id is None or sp.ignore_eos)
                    and not (sp.stop and self.tokenizer is not None)):
                # fast path: the window can only end a row by length.
                # Gather each iteration's accepted prefix with one mask,
                # truncate at max_tokens, roll device accounting back by
                # the unemitted remainder of the plan cap
                keep = np.arange(Dp)[None, :] < cs[:, None]
                row_t = tokens[:, i, :][keep].tolist()
                row_l = logprobs[:, i, :][keep].tolist()
                take = max(0, min(len(row_t),
                                  sp.max_tokens - req.num_output_tokens))
                if take > 0:
                    now = time.monotonic()
                    if not req.output_token_ids:
                        req.perf.first_token_time = now
                    req.perf.last_token_time = now
                    req.output_token_ids.extend(row_t[:take])
                    req.cum_logprob += sum(row_l[:take])
                    req.logprobs.extend(
                        {t: l} for t, l in zip(row_t[:take], row_l[:take]))
                if take < plan:
                    req.num_device_tokens -= plan - take
                if req.num_output_tokens >= sp.max_tokens:
                    req.finish_by_reason(FinishReason.LENGTH)
                    finished.append(req)
                else:
                    self._stream(req)
                continue
            accepted = 0
            done = False
            check_stop_strings = bool(sp.stop) and self.tokenizer is not None
            for k in range(K):
                for j in range(int(cs[k])):
                    tok = int(tokens[k, i, j])
                    lp = float(logprobs[k, i, j])
                    done = req.add_output_token(tok, lp)
                    if top_lp is not None and sp.logprobs:
                        vals, ids = top_lp
                        kk = sp.logprobs
                        req.logprobs[-1] = {
                            int(t): float(v) for v, t in
                            zip(vals[k, i, j][:kk], ids[k, i, j][:kk])}
                        req.logprobs[-1].setdefault(tok, lp)
                    accepted += 1
                    if not done and check_stop_strings:
                        done = self._check_stop_strings(req)
                    if done:
                        break
                if done:
                    break
            if accepted < plan:
                # normal for speculation: the plan is an emission CAP and
                # rejected drafts emit nothing. Roll host bookkeeping back
                # to what the device actually produced
                req.num_device_tokens -= plan - accepted
            if done:
                finished.append(req)
            else:
                self._stream(req)
        for req in finished:
            self._finish_request(req)

    def _stream(self, req: LlmRequest) -> None:
        res = self._results.get(req.request_id)
        if res is not None and req.streaming and \
                req.num_output_tokens - req.num_tokens_streamed >= \
                self.stream_interval:
            new = req.output_token_ids[req.num_tokens_streamed:]
            req.num_tokens_streamed = req.num_output_tokens
            res._on_tokens(new)

    def _advance_device_state(self, batch: ScheduledRequests):
        entries, samples = [], []
        for req in batch.context_requests:
            start = req.context_current_position
            end = min(req.context_len, start + req.context_chunk_size)
            last_chunk = end >= req.context_len
            req.context_current_position = end
            if last_chunk:
                req.state = LlmRequestState.GENERATION_IN_PROGRESS
                req.num_device_tokens = req.context_len
            entries.append(req)
            samples.append(last_chunk)
        drafts: List[List[int]] = [[] for _ in entries]
        for req in batch.generation_requests:
            drafts.append(list(req.draft_tokens))
            req.num_device_tokens += 1 + len(req.draft_tokens)
            req.draft_tokens = []
            req.host_token_override = None
            entries.append(req)
            samples.append(True)
        return entries, samples, drafts

    def _process_inflight(self):
        """Process the oldest in-flight dispatch's results. It leaves
        ``_inflight`` only once processed, so that a failure there
        implicates its requests (``_executor_loop``)."""
        if not self._inflight:
            return
        batch = self._inflight[0]
        if batch.kind == "multi":
            self._process_multi(batch)
        elif batch.kind == "spec":
            self._process_spec(batch)
        else:
            self._process_single(batch)
        self._inflight.popleft()

    def _process_single(self, batch: _InflightBatch) -> None:
        fetched = batch.result.get()               # sync point, one fetch
        G = self.engine.G
        tokens = fetched[0].reshape(-1, G)         # [S, G] logits rows
        logprobs = fetched[1].reshape(-1, G)
        hidden = fetched[-1] if self._stream_feats else None
        top_lp = fetched[2:4] if batch.has_top_lp else None
        proc_rows = {}
        if batch.logits_rows is not None:
            rows, fut = batch.logits_rows
            proc_rows = dict(zip(rows, fut.get()[0]))
            tokens = np.array(tokens)              # writable for overrides
            logprobs = np.array(logprobs)
        finished: List[LlmRequest] = []
        for i, req in enumerate(batch.entries):
            if req.is_finished:
                continue  # stopped while this step was in flight
            if not batch.samples_output[i]:
                continue  # mid-context chunk: logits unused
            if i in proc_rows:
                # host logits-processor path (sync mode): process the
                # row's logits, re-sample on the host and override the
                # device's sample, so that everything downstream (stop
                # checks, streaming, host_token_override) sees it. A
                # processor that raises fails its request alone (the JAX
                # executor.py:1674-1683)
                try:
                    tokens[i, 0], logprobs[i, 0] = self._run_processor(
                        req, proc_rows[i].copy())
                except Exception as pe:
                    if self.error_budget.consume(str(pe)):
                        raise
                    self._abort_request(
                        req, RequestError(req, "logits_processor", pe))
                    continue
            drafts = batch.drafts[i] if batch.drafts else []
            # chain verification: the longest prefix of drafts equal to
            # the target's own samples, plus one bonus token
            accepted = 0
            while accepted < len(drafts) and \
                    int(tokens[i, accepted]) == drafts[accepted]:
                accepted += 1
            rejected = len(drafts) - accepted
            k = req.sampling_params.logprobs
            for g in range(accepted + 1):
                tok = int(tokens[i, g])
                done = req.add_output_token(tok, float(logprobs[i, g]))
                if hidden is not None:
                    # the feature of the position that produced the token
                    req.eagle_feats.append((tok, hidden[i * G + g]))
                if self.guided_decoder is not None:
                    self.guided_decoder.observe_token(req, tok)
                if top_lp is not None and k:
                    vals, ids = top_lp
                    req.logprobs[-1] = {
                        int(t): float(v) for v, t in
                        zip(vals[i * G + g][:k], ids[i * G + g][:k])}
                    req.logprobs[-1].setdefault(tok, float(logprobs[i, g]))
                if not done and req.sampling_params.stop and \
                        self.tokenizer is not None:
                    done = self._check_stop_strings(req)
                if done:
                    # tokens past a stop are discarded
                    rejected += accepted - g
                    accepted = g
                    break
            if rejected:
                req.num_device_tokens -= rejected
                self.kv.rewind_tokens(req, 0)
            if drafts:
                self.drafted_rows += 1
                self.drafts_proposed += len(drafts)
                self.drafts_accepted += accepted
                self.host_drafter.update(req, drafts[:accepted])
            if not self.enable_overlap:
                req.host_token_override = int(tokens[i, accepted])
            if done:
                finished.append(req)
            elif req.streaming and \
                    req.num_output_tokens % self.stream_interval == 0:
                self._stream(req)
        for req in finished:
            self._finish_request(req)
        self._update_beam_groups()

    @staticmethod
    def _run_processor(req: LlmRequest, row: np.ndarray):
        """(token, logprob) of one processor row: the request's logits
        processor over the row, then the host sampler."""
        proc = req.sampling_params.logits_processor
        try:
            out = proc(req.request_id, row,
                       [list(req.output_token_ids)], None, None)
        except TypeError:
            out = proc(row)
        if out is not None:
            row = np.asarray(out, np.float64).reshape(-1)
        return _host_sample(row, req.sampling_params, req.num_output_tokens)

    def _update_beam_groups(self) -> None:
        """Re-rank each beam group whose rows all took a step since its
        last update (the JAX executor.py:1939-1980); a finished group
        hands its best hypothesis to the parent's result, the others as
        extra outputs, and ends its own rows. (The JAX executor ends the
        rows of the group its re-ranking loop visited last, so with two
        groups in flight one group's end cancels the other's rows, and
        that group never finishes.)"""
        done = []
        for pid, group in list(self._beam_groups.items()):
            rows = group.rows
            if any(r.is_context_init_state for r in rows):
                continue
            step = min(r.num_output_tokens for r in rows)
            if step <= group.steps:
                continue
            group.steps = step
            forks = group.forks
            group.update(self.engine, self.kv)
            self.beam_forks += group.forks - forks
            if group.done:
                done.append(pid)
        for pid in done:
            with self._lock:
                group = self._beam_groups.pop(pid)
            hyps = group.finalize()
            parent, rows = group.parent, group.rows
            # the parent never runs: its first and last token are its rows'
            parent.perf.first_token_time = min(
                r.perf.first_token_time for r in rows)
            parent.perf.last_token_time = max(
                r.perf.last_token_time for r in rows)
            parent.output_token_ids = list(hyps[0].tokens) if hyps else []
            parent.cum_logprob = hyps[0].score if hyps else 0.0
            parent.finish_by_reason(
                FinishReason.END_ID if (group.end_id is not None and hyps
                                        and hyps[0].tokens and
                                        hyps[0].tokens[-1] == group.end_id)
                else FinishReason.LENGTH)
            with self._lock:
                res = self._results.pop(parent.request_id, None)
            if res is not None:
                res._on_finish(inline=True)
                # the runner-up hypotheses as extra outputs
                for j, h in enumerate(hyps[1:], start=1):
                    res.outputs.append(CompletionOutput(
                        index=j, token_ids=list(h.tokens),
                        cumulative_logprob=h.score,
                        text=res._safe_decode(h.tokens),
                        finish_reason=res.outputs[0].finish_reason))
            for row in rows:
                row.cancel()
                self._finish_request(row)

    def _apply_bad_words(self, batch: ScheduledRequests
                         ) -> Optional[np.ndarray]:
        """Each row's single-token ban list (``SamplingParams.
        bad_token_ids``, ids inside the vocabulary) as i32[rows, n] with
        -1 padding, or None when no row has one. The JAX executor folds
        them into a [max_batch_size, V] bool mask copied up every step
        (executor.py:1982-1996); the step here scatters the ids to the
        same float32 minimum on the device."""
        reqs = batch.context_requests + batch.generation_requests
        V = self.engine.model.vocab_size
        lists = [[t for t in (r.sampling_params.bad_token_ids or ())
                  if 0 <= t < V] for r in reqs]
        width = max((len(x) for x in lists), default=0)
        if not width:
            return None
        out = np.full((len(reqs), width), -1, np.int32)
        for i, ids in enumerate(lists):
            out[i, :len(ids)] = ids
        return out

    def _release_slot(self, req: LlmRequest) -> None:
        if self.guided_decoder is not None:
            # clears the slot's grammar state (-1), after the windows in
            # flight, and drops the segment's reference
            self.guided_decoder.on_slot_released(req, self.engine)
        if self.engine._mrope:
            self.engine.set_mrope_delta(req.seq_slot, 0)
        self._free_slots.append(req.seq_slot)
        req.seq_slot = None

    def _check_stop_strings(self, req: LlmRequest) -> bool:
        """Text-level stop sequences (SamplingParams.stop), over a bounded
        decoded tail."""
        sp = req.sampling_params
        if req.num_output_tokens < sp.min_tokens:
            return False
        max_stop = max(len(s) for s in sp.stop)
        tail_tokens = req.output_token_ids[-(max_stop + 8):]
        try:
            text = self.tokenizer.decode(tail_tokens,
                                         skip_special_tokens=True)
        except Exception:  # a tokenizer fault must not kill the loop
            return False
        for stop in sp.stop:
            if text.find(stop) >= 0:
                req.finish_by_reason(FinishReason.STOP_WORDS)
                return True
        return False

    def _finish_request(self, req: LlmRequest):
        if self.tracer is not None:
            self.tracer.on_request_finished(req)
        if self.host_drafter is not None and \
                hasattr(self.host_drafter, "drop_request"):
            self.host_drafter.drop_request(req.request_id)
        if self.guided_decoder is not None:
            self.guided_decoder.drop(req.request_id)
        req.cross_states = None
        if self.kv_connector is not None and \
                self.kv_connector.on_request_finished(req):
            # an async external save in flight: blocks and slot stay held
            # until the worker reports it done (``_reap_finished``; the
            # JAX executor.py:2050-2062)
            if req in self._active:
                self._active.remove(req)
            self._save_parked.append(req)
            with self._lock:
                res = self._results.pop(req.request_id, None)
            if res is not None:
                res._on_finish()
            return
        self.kv.free_resources(req)
        if req.seq_slot is not None:
            self._release_slot(req)
        if req in self._active:
            self._active.remove(req)
        with self._lock:
            res = self._results.pop(req.request_id, None)
        if res is not None:
            res._on_finish()
