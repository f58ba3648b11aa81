"""Executor robustness in the port against the JAX package on the CPU: the
counterparts of tests/test_error_isolation.py, and cancellation,
iteration statistics and the hang detector.

- a logits processor that raises mid-batch fails only its request, with
  a ``RequestError``, in the port and in the JAX package alike, and the
  other requests' tokens equal the JAX package's; the loop serves later
  requests; the failed request's slot and KV blocks are released;
- a loop exception fails the requests of its iteration alone and the
  loop serves on; a sticky CUDA error fails every open request and ends
  the loop;
- ``classify_error`` on the CUDA runtime's messages, the budget's token
  bucket, severe errors at 5x and immediate-fatal ones, and
  ``explain_stage_oom``; an out-of-memory error while the KV pool is
  allocated names that stage;
- ``LLM.abort_request`` mid-window (overlap scheduler, K = 8) and in the
  queue: the request ends CANCELLED, the others' tokens equal the JAX
  package's;
- ``LLM.get_stats``: the JAX package's ``IterationStats`` fields;
- ``HangDetector`` fires on a wedged loop at a short timeout and stays
  quiet while disarmed.
"""
import dataclasses
import threading
import time
from pathlib import Path

import numpy as np
import pytest

CKPT = str(Path(__file__).parent / "assets" / "tinycode-llama")


def _prompts(n, seed=0):
    return [np.random.default_rng(seed + i).integers(1, 255, size=12)
            .tolist() for i in range(n)]


def _kw(sync, K=1):
    return dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=8,
                max_input_len=64, max_seq_len=256, max_num_tokens=256,
                decode_multi_step=K, disable_overlap_scheduler=sync)


def _llm(pkg, sync, K=1):
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    if pkg == "jax":
        return J.LLM(model=CKPT, kv_cache_config=J.KvCacheConfig(
            tokens_per_block=16, max_tokens=2048), **_kw(sync, K))
    return T.LLM(CKPT, device="cpu", kv_cache_config=T.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048), **_kw(sync, K))


@pytest.fixture(scope="module")
def sync_pair():
    j, t = _llm("jax", True), _llm("torch", True)
    yield j, t
    j.shutdown()
    t.shutdown()


@pytest.fixture(scope="module")
def overlap_pair():
    j, t = _llm("jax", False, K=8), _llm("torch", False, K=8)
    yield j, t
    j.shutdown()
    t.shutdown()


def _sp(pkg, **kw):
    if pkg == "jax":
        from tensorrt_llm_tpu import SamplingParams
    else:
        from tensorrt_llm_tpu_torch import SamplingParams
    return SamplingParams(**kw)


def _poison(*a, **kw):
    raise ValueError("poison processor")


def _errors(pkg):
    if pkg == "jax":
        from tensorrt_llm_tpu.runtime import error_isolation as m
    else:
        from tensorrt_llm_tpu_torch.runtime import error_isolation as m
    return m


def _wait_released(ex, blocks, slots):
    for _ in range(200):
        if (ex.kv.get_num_free_blocks() == blocks
                and len(ex._free_slots) == slots):
            return
        time.sleep(0.01)


# ---- per-request isolation ------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_poison_request_mid_batch_isolated(sync_pair, pkg):
    """One poison request of six fails with ``RequestError``; the five
    others finish, with the same tokens in both packages."""
    llm = sync_pair[0 if pkg == "jax" else 1]
    futs = [llm.generate_async(p, _sp(
        pkg, max_tokens=6, top_k=1, ignore_eos=True,
        logits_processor=_poison if i == 2 else None))
        for i, p in enumerate(_prompts(6))]
    with pytest.raises(_errors(pkg).RequestError):
        futs[2].result(timeout=120)
    got = [f.result(timeout=120).outputs[0].token_ids
           for i, f in enumerate(futs) if i != 2]
    assert all(len(t) == 6 for t in got)
    if pkg == "torch":
        j = sync_pair[0]
        want = [o.outputs[0].token_ids for o in j.generate(
            [p for i, p in enumerate(_prompts(6)) if i != 2],
            _sp("jax", max_tokens=6, top_k=1, ignore_eos=True))]
        assert got == want


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_loop_survives_for_later_requests(sync_pair, pkg):
    llm = sync_pair[0 if pkg == "jax" else 1]
    bad = llm.generate_async([1, 2, 3, 4], _sp(
        pkg, max_tokens=4, top_k=1, ignore_eos=True,
        logits_processor=_poison))
    with pytest.raises(_errors(pkg).RequestError):
        bad.result(timeout=120)
    out = llm.generate([5, 6, 7, 8], _sp(pkg, max_tokens=5, top_k=1,
                                         ignore_eos=True))
    assert len(out.outputs[0].token_ids) == 5
    assert all(r.request_id != bad.request_id
               for r in llm.executor._active)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_slot_and_kv_released_on_abort(sync_pair, pkg):
    llm = sync_pair[0 if pkg == "jax" else 1]
    ex = llm.executor
    blocks, slots = ex.kv.get_num_free_blocks(), len(ex._free_slots)
    bad = llm.generate_async([9, 8, 7, 6, 5], _sp(
        pkg, max_tokens=8, top_k=1, ignore_eos=True,
        logits_processor=_poison))
    with pytest.raises(_errors(pkg).RequestError):
        bad.result(timeout=120)
    _wait_released(ex, blocks, slots)
    assert ex.kv.get_num_free_blocks() == blocks
    assert len(ex._free_slots) == slots


def test_loop_exception_fails_its_iteration_only(sync_pair):
    """A step that raises fails the requests of its iteration (the JAX
    supervisor's culprits); the loop serves the next request."""
    t = sync_pair[1]
    eng = t.engine
    real = eng.forward_step
    calls = [0]

    def once(*a, **kw):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("injected step failure")
        return real(*a, **kw)
    eng.forward_step = once
    try:
        fut = t.generate_async([3, 4, 5], _sp("torch", max_tokens=6,
                                              top_k=1, ignore_eos=True))
        with pytest.raises(RuntimeError, match="injected"):
            fut.result(timeout=120)
    finally:
        eng.forward_step = real
    assert t.executor._thread.is_alive()
    out = t.generate([3, 4, 5], _sp("torch", max_tokens=6, top_k=1,
                                    ignore_eos=True))
    assert len(out.outputs[0].token_ids) == 6


def test_sticky_cuda_error_is_fatal():
    """An error CUDA reports as sticky poisons the context: every open
    request fails and the loop ends."""
    t = _llm("torch", True)
    try:
        eng = t.engine
        real = eng.forward_step
        gate = threading.Event()

        def boom(*a, **kw):
            gate.wait(30)
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        eng.forward_step = boom
        futs = [t.generate_async(p, _sp("torch", max_tokens=4, top_k=1))
                for p in _prompts(3)]
        gate.set()
        for f in futs:
            with pytest.raises(RuntimeError, match="illegal memory"):
                f.result(timeout=120)
        t.executor._thread.join(timeout=30)
        assert not t.executor._thread.is_alive()
        eng.forward_step = real
    finally:
        t.shutdown()


# ---- classification and budget --------------------------------------------

@pytest.mark.parametrize("msg,kind", [
    ("CUDA error: an illegal memory access was encountered",
     "immediate_fatal"),
    ("RuntimeError: CUDA error: device-side assert triggered",
     "immediate_fatal"),
    ("CUDA error: unspecified launch failure", "immediate_fatal"),
    ("CUDA error: misaligned address", "immediate_fatal"),
    ("CUBLAS_STATUS_EXECUTION_FAILED when calling cublasGemmEx",
     "immediate_fatal"),
    ("CUDA graph capture failed for step ('multi', 8): ...",
     "immediate_fatal"),
    ("CUDA out of memory. Tried to allocate 2.00 GiB", "severe"),
    ("ValueError: bad schema", "transient"),
    ("grammar needs 20001 DFA states", "transient")])
def test_classify_cuda_errors(msg, kind):
    from tensorrt_llm_tpu_torch.runtime.error_isolation import classify_error
    assert classify_error(msg) == kind


def test_oom_classified_as_the_jax_package_does():
    """The severe class keeps the JAX package's out-of-memory patterns."""
    from tensorrt_llm_tpu.runtime.error_isolation import classify_error as j
    from tensorrt_llm_tpu_torch.runtime.error_isolation import (
        classify_error as t)
    for msg in ("out of memory", "allocation failure", "host OOM",
                "ValueError: bad schema"):
        assert t(msg) == j(msg)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_error_budget_token_bucket(pkg):
    ErrorBudget = _errors(pkg).ErrorBudget
    b = ErrorBudget(budget=1.0, recovery_rate=0.1, cost=0.1)
    n = 0
    while not b.consume("boom", now=100.0):
        n += 1
        assert n < 20
    assert 9 <= n <= 11
    b2 = ErrorBudget(budget=0.0, recovery_rate=0.5, cost=0.1)
    b2.last_error_time = 0.0
    assert not b2.consume("boom", now=10.0)


def test_budget_severe_costs_5x():
    from tensorrt_llm_tpu_torch.runtime.error_isolation import ErrorBudget
    b = ErrorBudget()
    for _ in range(2):
        assert not b.consume("CUDA out of memory. Tried to allocate",
                             now=50.0)
    assert b.consume("CUDA out of memory", now=50.0)


def test_budget_immediate_fatal_bypasses():
    from tensorrt_llm_tpu_torch.runtime.error_isolation import ErrorBudget
    assert ErrorBudget().consume("CUDA error: misaligned address")


def test_explain_stage_oom():
    from tensorrt_llm_tpu_torch.runtime.error_isolation import (
        explain_stage_oom)
    msg = explain_stage_oom("kv_pool", RuntimeError("CUDA out of memory"))
    assert "KV-cache" in msg and "free_gpu_memory_fraction" in msg
    assert "capturing" in explain_stage_oom("warmup", RuntimeError("x"))


def test_creation_stage_names_the_kv_pool(monkeypatch):
    """An out-of-memory error while the engine sizes and allocates the KV
    pool reaches the caller naming that stage and its knob."""
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.llmapi import llm as llm_mod

    class Boom:
        def __init__(self, *a, **kw):
            raise RuntimeError("CUDA out of memory. Tried to allocate 9 GiB")
    monkeypatch.setattr(llm_mod, "ModelEngine", Boom)
    with pytest.raises(RuntimeError, match="KV-cache pool") as ei:
        T.LLM(CKPT, device="cpu", **_kw(True))
    assert "free_gpu_memory_fraction" in str(ei.value)


# ---- cancellation -----------------------------------------------------------

def test_abort_mid_window_matches_jax(overlap_pair):
    """On the overlap scheduler with K = 8, a long request aborted once it
    has 8 tokens ends CANCELLED, short of its length; the requests beside
    it return the JAX package's tokens."""
    j, t = overlap_pair
    prompts = _prompts(4, seed=10)
    kw = dict(max_tokens=40, top_k=1, ignore_eos=True)
    futs = [t.generate_async(p, _sp("torch", **kw)) for p in prompts[:3]]
    long = t.generate_async(prompts[3], _sp("torch", max_tokens=200,
                                            top_k=1, ignore_eos=True))
    while long._result.request.num_output_tokens < 8 and not long.finished:
        time.sleep(0.001)
    t.abort_request(long.request_id)
    out = long.result(timeout=120).outputs[0]
    assert out.finish_reason == "cancelled"
    assert 8 <= len(out.token_ids) < 200
    got = [f.result(timeout=120).outputs[0].token_ids for f in futs]
    want = [o.outputs[0].token_ids
            for o in j.generate(prompts[:3], _sp("jax", **kw))]
    assert got == want
    ex = t.executor
    _wait_released(ex, ex.kv.get_num_free_blocks(), 8)
    assert len(ex._free_slots) == 8 and not ex._active


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_abort_in_queue(overlap_pair, pkg):
    """A request cancelled before the executor admits it ends CANCELLED
    with no token at admission; the request queued beside it returns the
    tokens it returns alone."""
    llm = overlap_pair[0 if pkg == "jax" else 1]
    ex = llm.executor
    gate = threading.Event()
    fetch = ex._fetch_new_requests
    ex._fetch_new_requests = lambda: fetch() if gate.is_set() else None
    kw = dict(max_tokens=10, top_k=1, ignore_eos=True)
    try:
        a = llm.generate_async([7, 8, 9], _sp(pkg, **kw))
        b = llm.generate_async([10, 11, 12], _sp(pkg, **kw))
        llm.abort_request(a.request_id)
        gate.set()
        out = a.result(timeout=120).outputs[0]
        got = b.result(timeout=120).outputs[0].token_ids
    finally:
        ex._fetch_new_requests = fetch
    assert out.finish_reason == "cancelled" and out.token_ids == []
    assert got == llm.generate([10, 11, 12], _sp(pkg, **kw)).outputs[0] \
        .token_ids


# ---- statistics and the watchdog ------------------------------------------

def test_get_stats_fields_match_jax(overlap_pair):
    """``LLM.get_stats`` holds one ``IterationStats`` an iteration, with the
    JAX package's field names, counting on."""
    from tensorrt_llm_tpu.runtime.executor import IterationStats as J
    from tensorrt_llm_tpu_torch.runtime.executor import IterationStats as T
    assert [f.name for f in dataclasses.fields(T)] == \
        [f.name for f in dataclasses.fields(J)]
    t = overlap_pair[1]
    n0 = len(t.get_stats())
    t.generate(_prompts(2, seed=30), _sp("torch", max_tokens=12, top_k=1,
                                         ignore_eos=True))
    stats = t.get_stats()
    assert len(stats) > n0
    new = stats[n0:]
    assert [s.iter_counter for s in new] == \
        list(range(new[0].iter_counter, new[0].iter_counter + len(new)))
    assert any(s.num_ctx_tokens == 24 for s in new)
    assert any(s.num_gen_tokens == 2 for s in new)
    assert all(s.kv_cache_free_blocks > 0 and s.iter_latency_ms >= 0
               and s.moe_expert_skew is None and s.moe_rebalances == 0
               for s in new)


def test_hang_detector_fires_and_stays_quiet_disarmed():
    from tensorrt_llm_tpu_torch.runtime.hang_detector import HangDetector
    fired = threading.Event()
    hd = HangDetector(timeout_s=0.2, on_hang=fired.set)
    hd.start()
    try:
        hd.arm()                      # a wedged loop: no checkpoint
        assert fired.wait(3.0)
        fired.clear()
        hd.arm()
        hd.disarm()
        time.sleep(0.6)
        assert not fired.is_set()
        for _ in range(8):            # a loop that checkpoints in time
            hd.arm()
            time.sleep(0.03)
        hd.disarm()
        assert not fired.is_set()
    finally:
        hd.stop()


def test_executor_arms_the_detector(sync_pair):
    """The loop arms the detector while it has work and disarms it idle."""
    t = sync_pair[1]
    hd = t.executor._hang_detector
    t.generate([1, 2, 3], _sp("torch", max_tokens=4, top_k=1))
    for _ in range(100):
        if not hd._armed.is_set():
            break
        time.sleep(0.01)
    assert not hd._armed.is_set()
    assert hd.timeout_s == 600.0 and hd._thread.is_alive()
