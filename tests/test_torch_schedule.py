"""The serving schedule of the port's executor and engine against the JAX
package's, on the CPU: the rider plan (``plan_ctx_chunks``, exactly, for
seeded random context requests), the TTFT budget's window shrink, the
batching-wait and the rider bookkeeping after a mixed window."""
import types

import numpy as np
import pytest

from tensorrt_llm_tpu.runtime.model_engine import ModelEngine as JEngine
from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine as TEngine
from tensorrt_llm_tpu_torch.runtime.request import (LlmRequest,
                                                    LlmRequestState)
from tensorrt_llm_tpu_torch.runtime.scheduler import ScheduledRequests
from tensorrt_llm_tpu_torch.sampling_params import SamplingParams

PAGE = 16


def _ctx_requests(rng, n, P):
    """Context requests part way through their prompts, each holding a
    random set of KV pages."""
    reqs = []
    for _ in range(n):
        L = int(rng.integers(1, 120))
        blocks = rng.permutation(64)[:-(-L // PAGE)].tolist()
        reqs.append(types.SimpleNamespace(
            context_token_ids=rng.integers(1, 127, size=L).tolist(),
            context_len=L,
            context_current_position=int(rng.integers(0, L)),
            context_chunk_size=int(rng.integers(1, 80)),
            kv_block_ids=blocks))
    return reqs


@pytest.mark.parametrize("K", [1, 4, 8])
@pytest.mark.parametrize("C", [16, 32, 64])
@pytest.mark.parametrize("seed", range(4))
def test_plan_ctx_chunks_matches_jax(K, C, seed):
    """Same arrays (leading K axis, NC + 1 rows with the filler last,
    out-of-range slots for padding) and the same carved counts."""
    rng = np.random.default_rng(1000 * K + 10 * C + seed)
    P = 8
    eng = types.SimpleNamespace(mixed_ctx_tokens=C, page_size=PAGE,
                                pages_per_seq=P, num_kv_pages=64)
    nc = JEngine.mixed_ctx_seqs.fget(eng)
    assert TEngine.mixed_ctx_seqs.fget(eng) == nc
    eng.mixed_ctx_seqs = nc
    reqs = _ctx_requests(rng, int(rng.integers(1, 6)), P)
    jxs, jcarved = JEngine.plan_ctx_chunks(eng, reqs, K)
    txs, tcarved = TEngine.plan_ctx_chunks(eng, reqs, K)
    assert tcarved == jcarved
    assert set(txs) == set(jxs)
    for name in jxs:
        want = np.asarray(jxs[name])
        assert txs[name].dtype == want.dtype, name
        np.testing.assert_array_equal(txs[name], want, err_msg=name)
    assert txs["cu"].shape == (K, nc + 2)
    assert (txs["cu"][:, -1] == C).all()


# ---- the executor's schedule through a CPU ``LLM`` ----------------------

def _config():
    from transformers import LlamaConfig
    return LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=512)


def _llm(**kw):
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig
    return LLM(_config(), device="cpu", dtype="float32",
               skip_tokenizer_init=True, max_batch_size=4,
               max_input_len=64, max_seq_len=160, max_num_tokens=256,
               decode_multi_step=8,
               kv_cache_config=KvCacheConfig(tokens_per_block=PAGE,
                                             max_tokens=2048), **kw)


def _sp(n):
    return SamplingParams(max_tokens=n, top_k=1, ignore_eos=True)


def test_ttft_urgent_shrinks_window():
    """A 1 ms budget is always exceeded: windows shrink to K/4."""
    llm = _llm(ttft_slo_ms=1.0)
    try:
        ex = llm.executor
        assert ex.ttft_slo_ms == 1.0
        out = llm.generate_async([3, 1, 4, 1, 5], _sp(12)).result(300)
        assert len(out.outputs[0].token_ids) == 12
        assert ex.ttft_shrunk_iters >= 1
        shrunk = [k for k in llm.engine.graphs.steps if k[0] == "multi"]
        assert any(k[1] == 2 for k in shrunk)        # K/4 = 2
    finally:
        llm.shutdown()


def test_no_slo_keeps_full_window():
    llm = _llm()
    try:
        ex = llm.executor
        out = llm.generate_async([3, 1, 4, 1, 5], _sp(12)).result(300)
        assert len(out.outputs[0].token_ids) == 12
        assert ex._iter_K == ex.multi_step
        assert ex.ttft_shrunk_iters == 0
        assert {k[1] for k in llm.engine.graphs.steps if k[0] == "multi"} \
            == {8}
    finally:
        llm.shutdown()


def test_urgency_predicate():
    """Nothing waiting is never urgent; a request is urgent once it has
    waited past the budget without a first token, waiting or active."""
    from tensorrt_llm_tpu_torch.runtime.executor import PyExecutor
    llm = _llm(ttft_slo_ms=60_000.0)
    try:
        ex = llm.executor
        assert not ex._ttft_urgent()
        out = llm.generate_async([7, 7, 7], _sp(4)).result(300)
        assert len(out.outputs[0].token_ids) == 4
        assert ex._iter_K == ex.multi_step   # 60 s budget never tripped
    finally:
        llm.shutdown()
    old = LlmRequest(prompt_token_ids=[1, 2], sampling_params=_sp(2),
                     arrival_time=1.0)       # long ago
    new = LlmRequest(prompt_token_ids=[1, 2], sampling_params=_sp(2))

    def urgent(waiting, active):
        return PyExecutor._ttft_urgent(types.SimpleNamespace(
            ttft_slo_ms=60_000.0, waiting=waiting, _active=active))
    assert not urgent([new], [new])
    assert urgent([old], [])
    assert urgent([], [old])
    old.perf.first_token_time = 2.0
    assert not urgent([], [old])


@pytest.mark.parametrize("occupancy,n_gen,keeps_gen", [
    (0.0, 1, True),          # off
    (0.9, 1, False),         # 1 of 4 rows < 0.9 * 4: decode waits
    (0.9, 3, False),         # 3 < 3.6
    (0.75, 3, True),         # 3 = 0.75 * 4: at the target, decode runs
    (1.0, 4, True),          # a full pool never waits
])
def test_batching_wait_split(occupancy, n_gen, keeps_gen):
    """Context scheduled and the decode pool under the target: the
    generation rows sit out the iteration (paused requests kept)."""
    llm = _llm(decode_wait_occupancy=occupancy)
    try:
        ctx = [LlmRequest(prompt_token_ids=[1, 2, 3], sampling_params=_sp(2))]
        gen = [LlmRequest(prompt_token_ids=[4], sampling_params=_sp(2))
               for _ in range(n_gen)]
        paused = [LlmRequest(prompt_token_ids=[5], sampling_params=_sp(2))]
        out = llm.executor._batching_wait(ScheduledRequests(
            context_requests=list(ctx), generation_requests=list(gen),
            paused_requests=list(paused)))
        assert out.context_requests == ctx
        assert out.paused_requests == paused
        assert out.generation_requests == (gen if keeps_gen else [])
        # no context: decode always runs
        alone = llm.executor._batching_wait(
            ScheduledRequests(generation_requests=list(gen)))
        assert alone.generation_requests == gen
    finally:
        llm.shutdown()


def test_advance_ctx_riders_bookkeeping():
    """A partly carved prompt moves its context position; a fully carved
    one flips to generation one position before its first output, with
    its last prompt token as the next input; an uncarved one is left."""
    from tensorrt_llm_tpu_torch.runtime.executor import PyExecutor
    part, full, none = (LlmRequest(prompt_token_ids=list(range(1, n + 1)),
                                   sampling_params=_sp(4))
                        for n in (50, 30, 20))
    full.context_current_position = 10
    PyExecutor._advance_ctx_riders(None, [part, full, none], [16, 20, 0])
    assert part.context_current_position == 16
    assert part.state == LlmRequestState.CONTEXT_INIT
    assert part.host_token_override is None
    assert full.context_current_position == 30
    assert full.state == LlmRequestState.GENERATION_IN_PROGRESS
    assert full.num_device_tokens == 29
    assert full.host_token_override == 30
    assert none.context_current_position == 0
    assert none.state == LlmRequestState.CONTEXT_INIT
