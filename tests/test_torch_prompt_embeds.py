"""The port's prompt-embedding path (``LLM.generate_async`` dict prompts,
``LlmRequest.prompt_embeds``, models/modeling_utils.embed_tokens, the
engine's ``_prompt_embeds`` rows) against the JAX package on the CPU,
float32, greedy tokens equal:

- the model's own embedding rows reproduce the token-id stream (the JAX
  test_misc_features.py::test_prompt_embeds_override), by dict prompt
  and by a request submitted to the executor;
- random rows over some positions (NaN elsewhere) through the Llama,
  Gemma 2 (the sqrt(H) scale applies to overridden rows) and GPT-2
  (learned positions added to them) forwards: the JAX ``LLM``'s tokens;
- prompt tuning (virtual ids past the vocabulary take table rows): the
  JAX ``LLM``'s tokens;
- ``n = 2`` samples carry the embeddings; a request with embeddings never
  rides a decode window; the refusals.
"""
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T

PROMPT = [5, 9, 23, 44, 17, 3, 8]
KW = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
          max_input_len=64, max_seq_len=128, max_num_tokens=256)
KV = dict(tokens_per_block=16, max_tokens=1024)


def _hf(family):
    import transformers as tf
    torch.manual_seed(0)
    common = dict(vocab_size=128, num_hidden_layers=2,
                  max_position_embeddings=256)
    if family == "llama":
        return tf.LlamaForCausalLM(tf.LlamaConfig(
            hidden_size=64, intermediate_size=128, num_attention_heads=4,
            num_key_value_heads=2, **common)).eval()
    if family == "gemma2":
        return tf.Gemma2ForCausalLM(tf.Gemma2Config(
            hidden_size=64, intermediate_size=128, num_attention_heads=4,
            num_key_value_heads=2, head_dim=64, query_pre_attn_scalar=64,
            sliding_window=32, **common)).eval()
    # wider weights than the default 0.02: GPT-2's tiny random model
    # otherwise repeats one token whatever its prompt
    return tf.GPT2LMHeadModel(tf.GPT2Config(
        vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=256,
        initializer_range=0.2)).eval()


@pytest.fixture(scope="module")
def llama():
    return _hf("llama")


def _port(hf, **kw):
    return T.LLM(hf, device="cpu", kv_cache_config=T.KvCacheConfig(**KV),
                 **{**KW, **kw})


def _jax(hf, **kw):
    return J.LLM(model=hf, enable_warmup=False,
                 kv_cache_config=J.KvCacheConfig(**KV), **{**KW, **kw})


def _greedy(mod, n=1):
    return mod.SamplingParams(max_tokens=6, top_k=1, end_id=-1, n=n)


def _rows(hf, seed):
    """Random float32 rows at positions 1, 2 and 5 of PROMPT, NaN (the
    token lookup) elsewhere, 30 times as wide as the model's embeddings."""
    w = hf.get_input_embeddings().weight.detach().numpy()
    rng = np.random.default_rng(seed)
    rows = np.full((len(PROMPT), w.shape[1]), np.nan, np.float32)
    for i in (1, 2, 5):
        rows[i] = rng.standard_normal(w.shape[1]) * 30 * w.std()
    return rows


def test_own_embedding_rows_reproduce_the_token_stream(llama):
    from tensorrt_llm_tpu_torch.runtime.request import LlmRequest
    llm = _port(llama)
    try:
        ref = llm.generate(PROMPT, _greedy(T)).outputs[0].token_ids
        rows = llama.get_input_embeddings().weight.detach().numpy()[PROMPT]
        got = llm.generate({"prompt_token_ids": PROMPT,
                            "prompt_embeds": rows},
                           _greedy(T)).outputs[0].token_ids
        req = LlmRequest(prompt_token_ids=list(PROMPT),
                         sampling_params=_greedy(T),
                         prompt_embeds=np.asarray(rows, np.float32))
        out = llm.executor.submit(req).result(60)
        assert llm.engine.embed_steps == 2
    finally:
        llm.shutdown()
    assert got == ref
    assert out.request.output_token_ids == ref


@pytest.mark.parametrize("family", ["llama", "gemma2", "gpt2"])
def test_random_rows_match_jax_llm(family):
    hf = _hf(family)
    prompt = {"prompt_token_ids": PROMPT, "prompt_embeds": _rows(hf, 1)}
    j = _jax(hf)
    try:
        want = j.generate(prompt, _greedy(J)).outputs[0].token_ids
        plain = j.generate(PROMPT, _greedy(J)).outputs[0].token_ids
    finally:
        j.shutdown()
    llm = _port(hf)
    try:
        got = llm.generate(prompt, _greedy(T)).outputs[0].token_ids
    finally:
        llm.shutdown()
    assert got == want
    assert got != plain            # the rows changed the stream


def test_prompt_tuning_matches_jax_llm(llama):
    """Ids 128 and 129 (past the vocabulary) take rows 0 and 1 of the
    request's table."""
    table = np.random.default_rng(2).standard_normal((2, 64)).astype(
        np.float32) * 0.05
    prompt = {"prompt_token_ids": [5, 128, 129, 44, 17],
              "prompt_tuning_config": {"embedding_table": table}}
    j = _jax(llama)
    try:
        want = j.generate(prompt, _greedy(J))
    finally:
        j.shutdown()
    llm = _port(llama)
    try:
        got = llm.generate(prompt, _greedy(T))
        with pytest.raises(ValueError, match="outside the prompt table"):
            llm.generate_async({"prompt_token_ids": [5, 130],
                                "prompt_tuning_config": {
                                    "embedding_table": table}})
    finally:
        llm.shutdown()
    assert got.outputs[0].token_ids == want.outputs[0].token_ids
    assert got.prompt_token_ids == list(want.prompt_token_ids) == \
        [5, 0, 0, 44, 17]


def test_n2_samples_carry_the_embeddings(llama):
    prompt = {"prompt_token_ids": PROMPT, "prompt_embeds": _rows(llama, 3)}
    llm = _port(llama)
    try:
        got = llm.generate(prompt, _greedy(T, n=2))
        single = llm.generate(prompt, _greedy(T)).outputs[0].token_ids
    finally:
        llm.shutdown()
    assert [o.token_ids for o in got.outputs] == [single, single]


def test_embedding_requests_never_ride_a_window(llama):
    """With riders on (K-step windows that carve prompt chunks), a prompt
    with embeddings is prefilled in a step of its own: the decode rows'
    window never carries it, and its tokens are those it gets alone."""
    from tensorrt_llm_tpu_torch.runtime.request import LlmRequest
    prompt = {"prompt_token_ids": PROMPT, "prompt_embeds": _rows(llama, 4)}
    alone = _port(llama)
    try:
        want = alone.generate(prompt, _greedy(T)).outputs[0].token_ids
    finally:
        alone.shutdown()
    llm = _port(llama, decode_multi_step=4, mixed_window_ctx=64)
    try:
        assert not llm.executor._ctx_rider_ok(LlmRequest(
            [1, 2], prompt_embeds=np.zeros((2, 64), np.float32)))
        first = llm.generate_async(list(range(3, 30)), T.SamplingParams(
            max_tokens=40, top_k=1, end_id=-1))
        got = llm.generate_async(prompt, _greedy(T))
        first.result(120)
        assert got.result(120).outputs[0].token_ids == want
    finally:
        llm.shutdown()


def test_refusals(llama):
    llm = _port(llama)
    rows = _rows(llama, 5)
    try:
        with pytest.raises(ValueError, match="prompt_logprobs"):
            llm.generate_async({"prompt_token_ids": PROMPT,
                                "prompt_embeds": rows},
                               T.SamplingParams(max_tokens=2,
                                                prompt_logprobs=1))
        with pytest.raises(ValueError, match="do not cover"):
            llm.generate_async({"prompt_token_ids": PROMPT[:3],
                                "prompt_embeds": rows})
    finally:
        llm.shutdown()
