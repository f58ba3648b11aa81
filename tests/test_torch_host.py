"""The port's copies of the host runtime (KV block manager, schedulers)
against the JAX package's: the same random workload drives both, and
every block id, free count, reuse count and schedule must agree."""
import numpy as np
import pytest

from tensorrt_llm_tpu.runtime import kv_cache_manager as jkv
from tensorrt_llm_tpu.runtime import request as jreq
from tensorrt_llm_tpu.runtime import scheduler as jsched
from tensorrt_llm_tpu.sampling_params import SamplingParams as JSP
from tensorrt_llm_tpu_torch.runtime import kv_cache_manager as tkv
from tensorrt_llm_tpu_torch.runtime import request as treq
from tensorrt_llm_tpu_torch.runtime import scheduler as tsched
from tensorrt_llm_tpu_torch.sampling_params import SamplingParams as TSP


def _pair(prompt, rid, max_tokens):
    return (jreq.LlmRequest(prompt, JSP(max_tokens=max_tokens),
                            request_id=rid),
            treq.LlmRequest(prompt, TSP(max_tokens=max_tokens),
                            request_id=rid))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_manager_matches_jax(seed):
    """Shared prefixes (radix reuse), growth, frees into the reuse tree
    and eviction under a small pool."""
    rng = np.random.default_rng(seed)
    mgrs = (jkv.KVCacheManager(num_blocks=40, tokens_per_block=4),
            tkv.KVCacheManager(num_blocks=40, tokens_per_block=4))
    prefixes = [list(rng.integers(0, 50, size=12)) for _ in range(3)]
    live = []
    for rid in range(60):
        if live and (len(live) > 5 or rng.random() < 0.4):
            pair = live.pop(int(rng.integers(len(live))))
            for m, r in zip(mgrs, pair):
                m.free_resources(r)
        prompt = prefixes[rid % 3] + list(rng.integers(0, 50, size=int(
            rng.integers(1, 9))))
        pair = _pair(prompt, rid, 16)
        reused = []
        for m, r in zip(mgrs, pair):
            try:
                reused.append(m.add_sequence(r))
            except (jkv.NoFreeBlocksError, tkv.NoFreeBlocksError):
                reused.append("refused")
        assert reused[0] == reused[1]         # both refuse together
        if reused[0] == "refused":
            continue
        for _ in range(int(rng.integers(0, 6))):
            tok = int(rng.integers(0, 50))
            for m, r in zip(mgrs, pair):
                m.add_token(r)
                r.output_token_ids.append(tok)
        assert pair[0].kv_block_ids == pair[1].kv_block_ids
        assert mgrs[0].get_num_free_blocks() == mgrs[1].get_num_free_blocks()
        for r in pair:
            # as if every token's KV were written: the port stores only
            # the positions below num_device_tokens
            r.num_device_tokens = r.num_total_tokens
        live.append(pair)
    js, ts = mgrs[0].get_stats(), mgrs[1].get_stats()
    for f in ("free_blocks", "used_blocks", "reusable_blocks",
              "reused_blocks", "missed_blocks", "alloc_new_blocks"):
        assert getattr(js, f) == getattr(ts, f), f
    assert ts.reused_blocks > 0


@pytest.mark.parametrize("policy", ["GUARANTEED_NO_EVICT", "MAX_UTILIZATION"])
def test_scheduler_matches_jax(policy):
    rng = np.random.default_rng(3)
    kvs = (jkv.KVCacheManager(num_blocks=24, tokens_per_block=8),
           tkv.KVCacheManager(num_blocks=24, tokens_per_block=8))
    scheds = [mod.RequestScheduler(
        mod.CapacityScheduler(4, kv, mod.CapacitySchedulerPolicy[policy]),
        mod.MicroBatchScheduler(4, 48, chunk_unit_size=8))
        for mod, kv in zip((jsched, tsched), kvs)]
    pairs = [_pair(list(rng.integers(0, 99, size=int(n))), i, 12)
             for i, n in enumerate(rng.integers(5, 60, size=7))]
    for step in range(8):
        outs = [s.schedule([p[k] for p in pairs])
                for k, s in enumerate(scheds)]
        for attr in ("context_requests", "generation_requests",
                     "paused_requests"):
            a, b = (getattr(o, attr) for o in outs)
            assert [r.request_id for r in a] == [r.request_id for r in b]
            assert [r.context_chunk_size for r in a] == \
                [r.context_chunk_size for r in b]
        # advance both sides the same way: allocate and finish chunks
        for k, o in enumerate(outs):
            for r in o.context_requests:
                if r.request_id not in kvs[k]._seq_blocks:
                    kvs[k].add_sequence(r)
                r.move_to_next_context_chunk()
                if r.context_current_position >= r.context_len:
                    r.state = type(r.state).GENERATION_IN_PROGRESS
            for r in o.generation_requests:
                kvs[k].add_token(r)
                r.output_token_ids.append(step)
