"""The static-buffer path of the CUDA-graph runner on the CPU
(runtime/cuda_graph.py): on the CPU each key's static input buffer is
filled and its step runs eagerly on it, so these tests hold the buffer
plumbing that the card's graphs replay. A step of a bucket that ran with
more rows before must read none of them; a fixed-K window whose last
steps have no live row must leave what the K-step window clamped to the
rows' budgets leaves; kernel launches recorded at capture count once per
replay; and a capture that fails surfaces from ``generate``."""
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu_torch import KvCacheConfig
from tensorrt_llm_tpu_torch.llmapi.llm_args import LlmArgs
from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
from tensorrt_llm_tpu_torch.ops.cuda import _build
from tensorrt_llm_tpu_torch.ops.cuda import decode_attention as dec
from tensorrt_llm_tpu_torch.ops.cuda import prefill_attention as pre
from tensorrt_llm_tpu_torch.runtime.cuda_graph import GraphRunner
from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import KVCacheManager
from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine
from tensorrt_llm_tpu_torch.runtime.request import (LlmRequest,
                                                    LlmRequestState)
from tensorrt_llm_tpu_torch.runtime.scheduler import ScheduledRequests
from tensorrt_llm_tpu_torch.sampling_params import SamplingParams

PAGE = 16


def _config():
    from transformers import LlamaConfig
    return LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=512)


def _llm(**kw):
    from tensorrt_llm_tpu_torch import LLM
    args = dict(device="cpu", dtype="float32", skip_tokenizer_init=True,
                max_batch_size=64, max_input_len=32, max_seq_len=64,
                max_num_tokens=256, decode_multi_step=4,
                kv_cache_config=KvCacheConfig(tokens_per_block=PAGE,
                                              max_tokens=8192))
    args.update(kw)
    return LLM(_config(), **args)


def _greedy(n):
    return SamplingParams(max_tokens=n, top_k=1, ignore_eos=True)


def test_small_batch_after_large_one_in_a_bucket():
    """60 rows, then 3 rows, through the same window key (row bucket 64):
    the 3-row run gives a fresh engine's tokens, and every padding row of
    the static buffer holds padding values, not the 60-row batch's."""
    rng = np.random.default_rng(0)
    many = [rng.integers(1, 127, size=4).tolist() for _ in range(60)]
    few = [rng.integers(1, 127, size=5).tolist() for _ in range(3)]
    llm = _llm()
    try:
        llm.generate(many, _greedy(6))
        got = [o.outputs[0].token_ids for o in llm.generate(few, _greedy(6))]
        keys = [k for k in llm.engine.graphs.steps if k[0] == "multi"]
        step = llm.engine.graphs.steps[keys[0]]
    finally:
        llm.shutdown()
    assert len(keys) == 1 and keys[0][2] == 64
    rows = step.views["rows"]
    live = int((rows[3] >= 0).sum())
    assert 1 <= live <= 3
    assert (rows[3, live:] == -1).all()          # no slot: inactive
    assert (rows[1, live:] == -1).all()
    assert (rows[4, live:] == 0).all()
    assert (step.views["page_indices"][live:] == 0).all()
    assert (step.views["stop_ids"][live:] == -1).all()
    fresh = _llm()
    try:
        want = [o.outputs[0].token_ids
                for o in fresh.generate(few, _greedy(6))]
    finally:
        fresh.shutdown()
    assert got == want


# ---- an engine driven by hand ------------------------------------------

def _engine():
    args = LlmArgs(model="tiny", dtype="float32", max_batch_size=8,
                   max_input_len=64, max_seq_len=128, max_num_tokens=256,
                   kv_cache_config=KvCacheConfig(tokens_per_block=PAGE,
                                                 max_tokens=2048))
    model = get_model_class("llama")(ModelConfig(
        hf_config=_config(), dtype=torch.float32, device="cpu"))
    engine = ModelEngine(model, model.init_params(seed=0), args)
    kv = KVCacheManager(num_blocks=engine.num_kv_pages,
                        tokens_per_block=PAGE, max_seq_len=128,
                        enable_block_reuse=False)
    return engine, kv


def _prefilled(engine, kv, prompts, sps):
    """Requests through one prefill step, ready to decode."""
    reqs = []
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        r = LlmRequest(prompt_token_ids=p, sampling_params=sp)
        r.seq_slot = i
        kv.add_sequence(r)
        reqs.append(r)
    engine.forward_step(ScheduledRequests(context_requests=reqs))
    for r in reqs:
        r.state = LlmRequestState.GENERATION_IN_PROGRESS
        r.num_device_tokens = r.context_len
    return reqs


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("K", [4, 8])
def test_fixed_k_window_with_dead_steps(K, sampled):
    """Budgets 3, 1 and 2 in a K-step window: the steps past the third
    have no live row. Tokens, emitted counts, the KV pool and the slot
    state equal a window of 3 steps (the clamp the eager window had)."""
    rng = np.random.default_rng(K)
    prompts = [rng.integers(1, 127, size=n).tolist() for n in (9, 20, 5)]

    def sp(i):
        if not sampled:
            return _greedy(8)
        return SamplingParams(max_tokens=8, temperature=1.0, top_k=0,
                              seed=0 if i else 77, ignore_eos=True)
    runs = []
    for window in (K, 3):
        engine, kv = _engine()
        reqs = _prefilled(engine, kv, prompts, [sp(i) for i in range(3)])
        for r, budget in zip(reqs, (3, 1, 2)):
            kv.add_tokens(r, budget)
            r.multi_step_budget = budget
        tokens, logprobs, emitted, carved = engine.forward_multi_step(
            ScheduledRequests(generation_requests=reqs), window)
        assert carved == []
        assert tokens.shape[0] == window
        runs.append((engine, tokens, logprobs, emitted))
    (ea, ta, la, ma), (eb, tb, lb, mb) = runs
    assert ma.tolist()[:3] == mb.tolist()[:3] == [3, 1, 2]
    for i, e in enumerate((3, 1, 2)):
        assert torch.equal(ta[:e, i], tb[:e, i])
        assert torch.equal(la[:e, i], lb[:e, i])
    assert torch.equal(ea.kv_pages, eb.kv_pages)
    S = ea.max_batch_size                 # the trash slot may differ
    assert torch.equal(ea.prev_tokens[:S], eb.prev_tokens[:S])
    assert ea.window_steps == K and ea.dead_window_steps == K - 3
    assert eb.dead_window_steps == 0


@pytest.mark.parametrize("seed", [0, 1234], ids=["unseeded", "seeded"])
def test_seeded_rows_key_their_own_window(seed):
    """A sampled window draws the seeded rows' counter-based noise only
    when a row has a seed, and the key says which: two windows on the same
    inputs give an unseeded row new tokens (the generator advances) and a
    seeded row the same tokens."""
    engine, kv = _engine()
    sps = [SamplingParams(max_tokens=16, temperature=1.0, top_k=0, seed=s,
                          ignore_eos=True) for s in (0, seed)]
    reqs = _prefilled(engine, kv, [[3, 1, 4, 1, 5, 9, 2, 6]] * 2, sps)
    for r in reqs:
        r.host_token_override = 7              # the same input each time
        kv.add_tokens(r, 4)
        r.multi_step_budget = 4
    batch = ScheduledRequests(generation_requests=reqs)
    first = engine.forward_multi_step(batch, 4)[0]
    second = engine.forward_multi_step(batch, 4)[0]
    keys = [k for k in engine.graphs.steps if k[0] == "multi"]
    assert [k[-1] for k in keys] == [bool(seed)]
    assert not torch.equal(first[:, 0], second[:, 0])
    assert torch.equal(first[:, 1], second[:, 1]) == bool(seed)


def test_launches_counted_per_replay(monkeypatch):
    """A capture records the launches of its step once; every replay adds
    them to each kernel's ``LAUNCHES``. Without a capture, each eager run
    counts what it launched."""
    calls = []

    def body(v):
        calls.append(1)
        _build.count_launch(dec.__name__)
        _build.count_launch(dec.__name__)
        _build.count_launch(pre.__name__)
        return (v["x"] * 2,)

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    def capture(self, step, inert, fn):       # records, launches nothing
        with _build.tally_launches() as counts:
            step.outputs = fn(step.views)
        step.graph, step.launches = Graph(), counts

    monkeypatch.setattr(GraphRunner, "_capture", capture)
    runner = GraphRunner(torch.device("cpu"), torch.Generator(),
                         capture=False)
    runner.capture = True
    d0, p0 = dec.LAUNCHES, pre.LAUNCHES
    for i in range(3):
        out = runner.run(("k",), {"x": np.full(4, i, np.int32)}, body,
                         inert=lambda: {"x": np.zeros(4, np.int32)})
    assert len(calls) == 1 and Graph.replays == 3 and runner.replays == 3
    assert (dec.LAUNCHES - d0, pre.LAUNCHES - p0) == (6, 3)
    assert runner.steps[("k",)].views["x"].tolist() == [2] * 4
    assert out is runner.steps[("k",)].outputs

    eager = GraphRunner(torch.device("cpu"), torch.Generator(),
                        capture=False)
    for i in range(2):
        out = eager.run(("k",), {"x": np.full(4, i, np.int32)}, body,
                        inert=lambda: {"x": np.zeros(4, np.int32)})
    assert len(calls) == 3 and out[0].tolist() == [2] * 4
    assert (dec.LAUNCHES - d0, pre.LAUNCHES - p0) == (10, 5)


def test_capture_failure_raises_from_generate(monkeypatch):
    """A capture that fails is an error of the request, never an eager
    run in its place."""
    def fail(self, step, inert, body):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(GraphRunner, "_capture", fail)
    llm = _llm(max_batch_size=4)
    llm.engine.graphs.capture = True
    try:
        with pytest.raises(RuntimeError, match="capture failed"):
            llm.generate([1, 2, 3], _greedy(8))
        assert not llm.engine.graphs.steps
    finally:
        llm.shutdown()


def test_step_inputs_layout_is_checked():
    """Inputs of another shape than the key's buffer are refused."""
    runner = GraphRunner(torch.device("cpu"), torch.Generator(),
                         capture=False)
    runner.run(("k",), {"x": np.zeros(4, np.int32)}, lambda v: (v["x"],),
               inert=lambda: {"x": np.zeros(4, np.int32)})
    with pytest.raises(ValueError, match="layout"):
        runner.run(("k",), {"x": np.zeros(5, np.int32)}, lambda v: (v["x"],),
                   inert=lambda: {"x": np.zeros(5, np.int32)})
    with pytest.raises(TypeError, match="4-byte"):
        runner.run(("j",), {"x": np.zeros(4, np.int64)}, lambda v: (v["x"],),
                   inert=lambda: {"x": np.zeros(4, np.int64)})


@pytest.mark.parametrize("slo,mixed", [(0.0, 0), (50.0, 32)])
def test_warmup_captures_the_serving_keys(slo, mixed):
    """``warmup`` makes the greedy window of every row bucket at K (and
    K/4 with a TTFT budget), with and without riders, and the greedy
    decode-only step of every token bucket up to the batch size; the slot
    state is left at zero."""
    llm = _llm(max_batch_size=128, max_num_tokens=512, ttft_slo_ms=slo,
               mixed_window_ctx=mixed, max_seq_len=64)
    try:
        eng = llm.engine
        eng.prev_tokens.fill_(5)
        eng.warmup()
        keys = set(eng.graphs.steps)
    finally:
        llm.shutdown()
    Ks = [4, 1] if slo else [4]
    Cs = [0, mixed] if mixed else [0]
    want = {eng._window_key(k, Sb, C, eng._kv_bound(k), True, False)
            for Sb in eng.row_buckets for k in Ks for C in Cs}
    want |= {eng._step_key(T, eng._kv_bound(1), True, False, 0)
             for T in eng.token_buckets if T <= 128}
    assert eng.row_buckets == [64, 128]
    assert keys == want
    assert not eng.prev_tokens.any()
