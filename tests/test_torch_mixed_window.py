"""Mixed decode windows (context chunks riding inside the K-step window)
and the batching-wait, end to end on the CPU: the port's ``LLM`` and the
JAX package's ``LLM`` load one saved checkpoint (2 layers, hidden 64,
4 x 16 heads, vocab 128, float32) and serve the same staggered arrivals
with ``mixed_window_ctx=32`` and ``decode_multi_step=4``. Greedy tokens
must equal HF greedy decoding and each other exactly: riders change
where context KV is written, never its values. After
``tests/test_mixed_window.py``."""
import time

import numpy as np
import pytest

PAGE = 16


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    import torch
    from transformers import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(0)
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=512)
    model = LlamaForCausalLM(cfg).eval()
    path = tmp_path_factory.mktemp("tiny_llama")
    model.save_pretrained(path, safe_serialization=True)
    return str(path), model


def _kwargs(wait):
    return dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=8,
                max_input_len=96, max_seq_len=192, max_num_tokens=256,
                decode_multi_step=4, mixed_window_ctx=32,
                decode_wait_occupancy=wait)


def _llms(path, wait):
    from tensorrt_llm_tpu import LLM as JLLM
    from tensorrt_llm_tpu import KvCacheConfig as JKv
    from tensorrt_llm_tpu_torch import LLM as TLLM
    from tensorrt_llm_tpu_torch import KvCacheConfig as TKv
    jllm = JLLM(model=path, kv_cache_config=JKv(tokens_per_block=PAGE,
                                                max_tokens=4096),
                **_kwargs(wait))
    tllm = TLLM(path, device="cpu", kv_cache_config=TKv(
        tokens_per_block=PAGE, max_tokens=4096), **_kwargs(wait))
    return jllm, tllm


@pytest.fixture(scope="module")
def llms(ckpt):
    jllm, tllm = _llms(ckpt[0], 0.0)
    yield jllm, tllm
    jllm.shutdown()
    tllm.shutdown()


def _sp(pkg, **kw):
    if pkg == "jax":
        from tensorrt_llm_tpu import SamplingParams
    else:
        from tensorrt_llm_tpu_torch import SamplingParams
    return SamplingParams(**kw)


def hf_greedy(model, prompt, n):
    import torch
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = model(torch.tensor([ids])).logits[0, -1]
            ids.append(int(torch.argmax(logits)))
    return ids[len(prompt):]


def _staggered(llm, pkg, prompts, n_out, first=2):
    """The first ``first`` prompts decode; the rest arrive once the first
    has produced tokens, so they are scheduled beside decode rows."""
    sp = _sp(pkg, max_tokens=n_out, top_k=1, ignore_eos=True)
    futs = [llm.generate_async(p, sp) for p in prompts[:first]]
    deadline = time.monotonic() + 120
    while not futs[0]._result.request.output_token_ids \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    futs += [llm.generate_async(p, sp) for p in prompts[first:]]
    return [f.result(300).outputs[0].token_ids for f in futs]


def _engaged(tllm):
    e = tllm.engine
    return e.mixed_windows_dispatched, e.mixed_ctx_carved


def test_mixed_window_configured(llms):
    _, tllm = llms
    assert tllm.engine.mixed_ctx_tokens == 32
    assert tllm.engine.mixed_ctx_seqs == 2


def test_staggered_arrivals_greedy_parity(llms, ckpt):
    """Requests arriving while others decode ride the mixed window; every
    stream equals HF greedy and the JAX package's stream, and riders
    carried context tokens."""
    jllm, tllm = llms
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 127, size=n).tolist()
               for n in (40, 55, 33, 61, 24, 47)]
    before = _engaged(tllm)
    t = _staggered(tllm, "torch", prompts, 24)
    j = _staggered(jllm, "jax", prompts, 24)
    after = _engaged(tllm)
    assert after[0] > before[0] and after[1] > before[1], \
        "no rider window was dispatched"
    for p, a, b in zip(prompts, t, j):
        assert a == hf_greedy(ckpt[1], p, 24)
        assert a == b


def test_long_prompt_carved_across_steps(llms, ckpt):
    """An 89-token prompt beside a decoding row is carved over several
    window steps (C = 32) and still gives the exact greedy stream."""
    jllm, tllm = llms
    prompts = [[5, 6, 7], list(range(1, 90))]
    t = _staggered(tllm, "torch", prompts, 10, first=1)
    j = _staggered(jllm, "jax", prompts, 10, first=1)
    assert t == j
    assert t[1] == hf_greedy(ckpt[1], prompts[1], 10)


def test_stop_and_eos_in_mixed_windows(llms, ckpt):
    """A stop token id and an end id that land inside windows that carry
    riders end their streams as in the JAX package."""
    jllm, tllm = llms
    anchor = [9, 8, 7, 6]
    ref = hf_greedy(ckpt[1], anchor, 20)
    rng = np.random.default_rng(5)
    riders = [rng.integers(1, 127, size=n).tolist() for n in (45, 38)]
    outs = {}
    for pkg, llm in (("torch", tllm), ("jax", jllm)):
        before = _engaged(tllm)
        stop = llm.generate_async(anchor, _sp(
            pkg, max_tokens=20, top_k=1, stop_token_ids=[ref[5]]))
        eos = llm.generate_async(anchor, _sp(
            pkg, max_tokens=20, top_k=1, end_id=ref[7]))
        while not stop._result.request.output_token_ids:
            time.sleep(0.005)
        rest = [llm.generate_async(p, _sp(pkg, max_tokens=6, top_k=1,
                                          ignore_eos=True)) for p in riders]
        outs[pkg] = [f.result(300).outputs[0] for f in [stop, eos] + rest]
        if pkg == "torch":
            assert _engaged(tllm)[0] > before[0]
    t, j = outs["torch"], outs["jax"]
    assert t[0].token_ids == ref[:6] == j[0].token_ids
    assert t[0].finish_reason == j[0].finish_reason == "stop_words"
    assert t[1].token_ids == j[1].token_ids
    assert t[1].finish_reason == j[1].finish_reason
    for a, b, p in zip(t[2:], j[2:], riders):
        assert a.token_ids == b.token_ids == hf_greedy(ckpt[1], p, 6)


def test_batching_wait_lossless(ckpt):
    """decode_wait_occupancy=0.9 defers decode while prefill refills; the
    streams stay exactly greedy and equal to the JAX package's."""
    jllm, tllm = _llms(ckpt[0], 0.9)
    try:
        rng = np.random.default_rng(11)
        prompts = [rng.integers(1, 127, size=n).tolist()
                   for n in (50, 33, 61, 44, 28, 55)]
        t = _staggered(tllm, "torch", prompts, 20)
        j = _staggered(jllm, "jax", prompts, 20)
    finally:
        jllm.shutdown()
        tllm.shutdown()
    for p, a, b in zip(prompts, t, j):
        assert len(a) == 20
        assert a == b == hf_greedy(ckpt[1], p, 20)


def test_bench_settings_greedy_parity(ckpt):
    """bench.py's serving settings (K = 16, depth 3, 512 rider tokens,
    full-pool batching-wait, a TTFT budget) build in both packages and
    give the same greedy tokens, equal to HF greedy."""
    from tensorrt_llm_tpu import LLM as JLLM
    from tensorrt_llm_tpu import KvCacheConfig as JKv
    from tensorrt_llm_tpu_torch import LLM as TLLM
    from tensorrt_llm_tpu_torch import KvCacheConfig as TKv
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=8,
              max_input_len=96, max_seq_len=192, max_num_tokens=512,
              decode_multi_step=16, max_inflight_steps=3,
              mixed_window_ctx=512, decode_wait_occupancy=1.0,
              ttft_slo_ms=50.0)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 127, size=int(n)).tolist()
               for n in rng.integers(10, 80, size=12)]
    outs = {}
    for pkg, make in (
            ("torch", lambda: TLLM(ckpt[0], device="cpu", kv_cache_config=TKv(
                tokens_per_block=PAGE, max_tokens=4096), **kw)),
            ("jax", lambda: JLLM(model=ckpt[0], kv_cache_config=JKv(
                tokens_per_block=PAGE, max_tokens=4096), **kw))):
        llm = make()
        try:
            outs[pkg] = _staggered(llm, pkg, prompts, 20, first=4)
        finally:
            llm.shutdown()
    assert outs["torch"] == outs["jax"]
    for p, o in zip(prompts, outs["torch"]):
        assert o == hf_greedy(ckpt[1], p, 20)
