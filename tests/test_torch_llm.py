"""End to end: the port's ``LLM.generate`` on the CPU against the JAX
package's ``LLM`` with the same arguments, on the in-repo parity
checkpoint (tests/assets/tinycode-llama, float32). Greedy tokens must be
identical, with K-step decode windows (decode_multi_step=8, the default)
and with one-token steps (1)."""
from pathlib import Path

import pytest

CKPT = str(Path(__file__).parent / "assets" / "tinycode-llama")
PROMPT = list(b"def forward(self, x):\n    return ")


def _kwargs(K):
    return dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=8,
                max_input_len=128, max_seq_len=256, max_num_tokens=256,
                decode_multi_step=K)


@pytest.fixture(scope="module", params=[8, 1], ids=["K8", "K1"])
def llms(request):
    from tensorrt_llm_tpu import LLM as JLLM
    from tensorrt_llm_tpu import KvCacheConfig as JKv
    from tensorrt_llm_tpu_torch import LLM as TLLM
    from tensorrt_llm_tpu_torch import KvCacheConfig as TKv
    K = request.param
    jllm = JLLM(model=CKPT, kv_cache_config=JKv(tokens_per_block=16,
                                                max_tokens=2048),
                **_kwargs(K))
    tllm = TLLM(CKPT, device="cpu",
                kv_cache_config=TKv(tokens_per_block=16, max_tokens=2048),
                **_kwargs(K))
    yield jllm, tllm
    jllm.shutdown()
    tllm.shutdown()


def _sp(pkg, **kw):
    if pkg == "jax":
        from tensorrt_llm_tpu import SamplingParams
    else:
        from tensorrt_llm_tpu_torch import SamplingParams
    return SamplingParams(**kw)


def _both(llms, prompts, **kw):
    jllm, tllm = llms
    j = jllm.generate(prompts, _sp("jax", **kw))
    t = tllm.generate(prompts, _sp("torch", **kw))
    if not isinstance(j, list):
        j, t = [j], [t]
    return ([o.outputs[0] for o in j], [o.outputs[0] for o in t])


def test_single_prompt(llms):
    j, t = _both(llms, PROMPT, max_tokens=20, top_k=1)
    assert t[0].token_ids == j[0].token_ids
    assert len(t[0].token_ids) == 20
    assert t[0].finish_reason == j[0].finish_reason == "length"


def test_batch_of_three(llms):
    prompts = [PROMPT[:5], list(b"import numpy as np\n"), PROMPT * 2]
    j, t = _both(llms, prompts, max_tokens=12, top_k=1)
    assert [o.token_ids for o in t] == [o.token_ids for o in j]


def test_streaming(llms):
    jllm, tllm = llms
    ref = jllm.generate(PROMPT, _sp("jax", max_tokens=10, top_k=1))
    fut = tllm.generate_async(PROMPT, _sp("torch", max_tokens=10, top_k=1),
                              streaming=True)
    streamed = []
    for out in fut:
        streamed.extend(out.token_ids)
    fut.result(timeout=120)
    assert streamed == ref.outputs[0].token_ids


def test_stop_token(llms):
    jllm, _ = llms
    ref = jllm.generate(PROMPT, _sp("jax", max_tokens=12, top_k=1))
    stop = ref.outputs[0].token_ids[4]
    j, t = _both(llms, PROMPT, max_tokens=12, top_k=1,
                 stop_token_ids=[stop])
    assert t[0].token_ids == j[0].token_ids
    assert t[0].token_ids[-1] == stop
    assert t[0].finish_reason == j[0].finish_reason


def test_max_tokens(llms):
    j, t = _both(llms, [1, 2, 3], max_tokens=3, top_k=1)
    assert t[0].token_ids == j[0].token_ids
    assert len(t[0].token_ids) == 3


def test_prefix_reuse(llms):
    _, tllm = llms
    prompt = list(b"class Engine:\n    def __init__(self, model):\n"
                  b"        self.model = model\n")      # > 3 pages of 16
    j1, t1 = _both(llms, prompt, max_tokens=6, top_k=1)
    j2, t2 = _both(llms, prompt, max_tokens=6, top_k=1)
    assert t1[0].token_ids == t2[0].token_ids == j1[0].token_ids \
        == j2[0].token_ids
    assert tllm.kv_cache_manager.get_stats().reused_blocks > 0


def test_hot_temperature_is_diverse(llms):
    _, tllm = llms
    outs = [tllm.generate(PROMPT[:4], _sp("torch", max_tokens=12,
                                          temperature=5.0))
            for _ in range(3)]
    assert len({tuple(o.outputs[0].token_ids) for o in outs}) > 1


def test_seeded_sampling_is_reproducible(llms):
    """A request's seed fixes its sampled stream; other seeds at a hot
    temperature give other streams."""
    _, tllm = llms

    def run(seed):
        return tuple(tllm.generate(PROMPT[:4], _sp(
            "torch", max_tokens=12, temperature=5.0, seed=seed))
            .outputs[0].token_ids)
    assert run(11) == run(11)
    assert len({run(s) for s in (11, 12, 13)}) > 1
