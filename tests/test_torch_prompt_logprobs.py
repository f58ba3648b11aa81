"""``prompt_logprobs`` in the port against the JAX package on the CPU
(tests/assets/tinycode-llama, float32):

- ``prompt_logprob_dicts``: the same keys as the JAX function (the prompt
  token and the top-k per position, None at position 0), values within
  rtol 1e-4 / atol 1e-5, the JAX test's tolerance
  (tests/test_misc_features.py:305-325); ``score_token_logprobs`` the
  same;
- the chunked teacher-forced forward equals one unchunked pass within
  the same tolerance (the same float32 arithmetic per query row, whose
  attention and projections run over other shapes, so sums round in
  another order: 1.1e-5 at a log-probability of -8.7 is seen);
- through ``LLM.generate``: ``RequestOutput.prompt_logprobs`` equal to
  the JAX ``LLM``'s, computed on the executor thread, for n > 1 and beam
  search too.
"""
import threading
from pathlib import Path

import numpy as np
import pytest

CKPT = str(Path(__file__).parent / "assets" / "tinycode-llama")
PROMPT = list(b"def forward(self, x):\n    return self.linear(x) + 1\n")
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def llms():
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=8,
              max_input_len=96, max_seq_len=160, max_num_tokens=256,
              max_beam_width=2)
    j = J.LLM(model=CKPT, kv_cache_config=J.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048), **kw)
    t = T.LLM(CKPT, device="cpu", kv_cache_config=T.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048), **kw)
    yield j, t
    j.shutdown()
    t.shutdown()


def _sp(pkg, **kw):
    if pkg == "jax":
        from tensorrt_llm_tpu import SamplingParams
    else:
        from tensorrt_llm_tpu_torch import SamplingParams
    return SamplingParams(**kw)


def _assert_dicts_equal(got, want):
    assert len(got) == len(want)
    assert got[0] is None and want[0] is None
    for g, w in zip(got[1:], want[1:]):
        assert set(g) == set(w)
        keys = sorted(w)
        np.testing.assert_allclose([g[k] for k in keys], [w[k] for k in keys],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("top_k", [0, 1, 5])
def test_prompt_logprob_dicts_match_jax(llms, top_k):
    from tensorrt_llm_tpu.evaluate.perplexity import \
        prompt_logprob_dicts as jd
    from tensorrt_llm_tpu_torch.evaluate.perplexity import \
        prompt_logprob_dicts as td
    j, t = llms
    want = jd(j.model, j.engine.params, PROMPT, top_k=top_k)
    got = td(t.model, t.engine.params, PROMPT, top_k=top_k)
    _assert_dicts_equal(got, want)
    for entry in got[1:]:
        assert len(entry) >= max(1, top_k)


def test_score_token_logprobs_match_jax(llms):
    from tensorrt_llm_tpu.evaluate.perplexity import perplexity as jp
    from tensorrt_llm_tpu.evaluate.perplexity import \
        score_token_logprobs as js
    from tensorrt_llm_tpu_torch.evaluate.perplexity import perplexity as tp
    from tensorrt_llm_tpu_torch.evaluate.perplexity import \
        score_token_logprobs as ts
    j, t = llms
    want = js(j.model, j.engine.params, PROMPT)
    got = ts(t.model, t.engine.params, PROMPT)
    assert got.dtype == np.float32 and got.shape == (len(PROMPT) - 1,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert tp(t.model, t.engine.params, PROMPT) == pytest.approx(
        jp(j.model, j.engine.params, PROMPT), rel=RTOL)


@pytest.mark.parametrize("chunk", [1, 7, 16])
def test_chunked_forward_equals_one_pass(llms, chunk):
    """Chunks of query rows over one pool give one pass's keys and its
    values within rtol 1e-4 / atol 1e-5."""
    from tensorrt_llm_tpu_torch.evaluate.perplexity import \
        prompt_logprob_dicts as td
    t = llms[1]
    one = td(t.model, t.engine.params, PROMPT, top_k=3, chunk=len(PROMPT))
    got = td(t.model, t.engine.params, PROMPT, top_k=3, chunk=chunk)
    assert len(got) == len(one)
    for g, w in zip(got[1:], one[1:]):
        assert set(g) == set(w)
        keys = sorted(w)
        np.testing.assert_allclose([g[k] for k in keys], [w[k] for k in keys],
                                   rtol=RTOL, atol=ATOL)


def test_llm_prompt_logprobs_match_jax(llms):
    j, t = llms
    want = j.generate(PROMPT, _sp("jax", max_tokens=3, top_k=1,
                                  prompt_logprobs=4))
    got = t.generate(PROMPT, _sp("torch", max_tokens=3, top_k=1,
                                 prompt_logprobs=4))
    _assert_dicts_equal(got.prompt_logprobs, want.prompt_logprobs)
    assert got.outputs[0].token_ids == want.outputs[0].token_ids
    plain = t.generate(PROMPT, _sp("torch", max_tokens=3, top_k=1))
    assert plain.prompt_logprobs is None


def test_prompt_logprobs_run_on_the_executor_thread(llms):
    """The teacher-forced forward runs on the executor's thread (a launch
    from the caller's thread could break a CUDA graph capture there)."""
    from tensorrt_llm_tpu_torch.evaluate import perplexity
    t = llms[1]
    seen = []
    orig = perplexity.prompt_logprob_dicts

    def spy(*a, **kw):
        seen.append(threading.current_thread().name)
        return orig(*a, **kw)
    perplexity.prompt_logprob_dicts = spy
    try:
        n0 = t.executor.prompt_logprob_forwards
        t.generate(PROMPT, _sp("torch", max_tokens=2, top_k=1,
                               prompt_logprobs=1))
    finally:
        perplexity.prompt_logprob_dicts = orig
    assert seen == [t.executor._thread.name]
    assert t.executor.prompt_logprob_forwards == n0 + 1


def test_prompt_logprobs_with_n_and_beams(llms):
    """n > 1 and beam search return the prompt's logprobs once, on the
    request's output, equal to the JAX ``LLM``'s."""
    j, t = llms
    for kw in (dict(n=3, temperature=0.8, seed=7),
               dict(use_beam_search=True, best_of=2, n=2)):
        want = j.generate(PROMPT[:20], _sp("jax", max_tokens=3,
                                           prompt_logprobs=2, **kw))
        n0 = t.executor.prompt_logprob_forwards
        got = t.generate(PROMPT[:20], _sp("torch", max_tokens=3,
                                          prompt_logprobs=2, **kw))
        _assert_dicts_equal(got.prompt_logprobs, want.prompt_logprobs)
        assert len(got.outputs) == len(want.outputs)
        assert t.executor.prompt_logprob_forwards == n0 + 1
