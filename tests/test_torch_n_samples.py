"""``SamplingParams.n > 1`` in the port (the JAX ``LLM.generate_async``'s
siblings, llm.py:844-860), on the CPU with tests/assets/tinycode-llama in
float32:

- greedy: n identical outputs with the indices 0 to n-1, equal to the
  JAX ``LLM``'s;
- seeded sampling: sibling j equals a single request carrying the folded
  seed ``(seed * 0x9E3779B1 + j) & 0x7FFFFFFF or 1`` (the port's seeded
  noise is its own counter hash, so the streams match the JAX package by
  construction, not by bits);
- siblings share the prompt through the reuse tree: once the prompt's
  blocks are stored, every sibling reuses them.
"""
from pathlib import Path

import pytest

CKPT = str(Path(__file__).parent / "assets" / "tinycode-llama")
PROMPT = list(b"class Net(nn.Module):\n    def __init__(self):\n"
              b"        super().__init__()\n        self.")


@pytest.fixture(scope="module")
def llm():
    import tensorrt_llm_tpu_torch as T
    t = T.LLM(CKPT, device="cpu", skip_tokenizer_init=True, dtype="float32",
              max_batch_size=8, max_input_len=96, max_seq_len=160,
              max_num_tokens=256,
              kv_cache_config=T.KvCacheConfig(tokens_per_block=16,
                                              max_tokens=2048))
    yield t
    t.shutdown()


def _sp(**kw):
    from tensorrt_llm_tpu_torch import SamplingParams
    return SamplingParams(**kw)


def test_greedy_siblings_are_identical_and_match_jax(llm):
    import tensorrt_llm_tpu as J
    j = J.LLM(model=CKPT, skip_tokenizer_init=True, dtype="float32",
              max_batch_size=8, max_input_len=96, max_seq_len=160,
              max_num_tokens=256,
              kv_cache_config=J.KvCacheConfig(tokens_per_block=16,
                                              max_tokens=2048))
    try:
        want = j.generate(PROMPT, J.SamplingParams(max_tokens=10, top_k=1,
                                                   n=4))
    finally:
        j.shutdown()
    got = llm.generate(PROMPT, _sp(max_tokens=10, top_k=1, n=4))
    assert [o.index for o in got.outputs] == [0, 1, 2, 3]
    assert [o.index for o in want.outputs] == [0, 1, 2, 3]
    toks = [o.token_ids for o in got.outputs]
    assert toks == [o.token_ids for o in want.outputs]
    assert all(t == toks[0] for t in toks)
    assert got.finished


@pytest.mark.parametrize("seed", [5, 123456])
def test_seeded_siblings_equal_single_requests(llm, seed):
    sp = dict(max_tokens=12, temperature=0.9, top_p=0.95, ignore_eos=True)
    got = llm.generate(PROMPT, _sp(n=3, seed=seed, **sp))
    toks = [o.token_ids for o in got.outputs]
    for j, t in enumerate(toks):
        folded = seed if j == 0 else (seed * 0x9E3779B1 + j) & 0x7FFFFFFF \
            or 1
        single = llm.generate(PROMPT, _sp(seed=folded, **sp))
        assert single.outputs[0].token_ids == t
    assert len({tuple(t) for t in toks}) == 3


def test_siblings_reuse_the_prompt_blocks(llm):
    """The prompt's full blocks, stored by a first request, are reused by
    each of the n siblings."""
    kv = llm.kv_cache_manager
    llm.generate(PROMPT, _sp(max_tokens=2, top_k=1))
    before = kv.get_stats().reused_blocks
    n = 4
    llm.generate(PROMPT, _sp(max_tokens=4, temperature=1.0, seed=9, n=n))
    full = (len(PROMPT) - 1) // 16
    assert full >= 3
    assert kv.get_stats().reused_blocks - before == n * full
