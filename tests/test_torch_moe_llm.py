"""MoE and Qwen models end to end: the port's ``LLM.generate`` on the CPU
against the JAX package's ``LLM`` with the same arguments, float32.

- Tiny Qwen3-MoE and Qwen2-MoE models (tests/test_torch_families.py's
  seeded ``transformers`` models, saved to a temporary directory): greedy
  tokens identical, with K-step windows (the default, K = 8) and with
  one-token steps.
- A Qwen3-MoE at widths the dequant-matmul kernel takes (hidden 256,
  group 64), served with W4A16_AWQ by both packages (the JAX side's Pallas
  kernel in interpret mode; the experts stay float in both): greedy
  tokens identical wherever the JAX run decides by more than 3e-2 in
  log-probability, the kernel route's logit tolerance
  (tests/test_torch_quant_model.py), and at least half of them before
  any parting.
- EAGLE3 with a Qwen3 (dense) target, which the JAX package serves too:
  the spec run's greedy tokens equal the run without speculation.
"""
import pytest

from tests.test_torch_families import save_random

PROMPTS = [[5, 17, 99, 3, 64, 12, 7], list(range(20, 61)), [101, 2, 33]]
N_OUT = 16


def _kwargs(K=8):
    return dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
                max_input_len=64, max_seq_len=128, max_num_tokens=128,
                decode_multi_step=K)


def _greedy(pkg_name, path, algo=None, logprobs=None, **kw):
    if pkg_name == "jax":
        import tensorrt_llm_tpu as P
        extra = dict(model=str(path))
    else:
        import tensorrt_llm_tpu_torch as P
        extra = dict(model=str(path), device="cpu")
    if algo is not None:
        kw["quant_config"] = P.QuantConfig(quant_algo=P.QuantAlgo[algo],
                                           group_size=64)
    llm = P.LLM(kv_cache_config=P.KvCacheConfig(tokens_per_block=16,
                                                max_tokens=1024),
                **extra, **kw)
    try:
        outs = llm.generate(PROMPTS, P.SamplingParams(
            max_tokens=N_OUT, top_k=1, ignore_eos=True, logprobs=logprobs))
    finally:
        llm.shutdown()
    return ([o.outputs[0].token_ids for o in outs],
            [o.outputs[0].logprobs for o in outs])


@pytest.mark.parametrize("K", [8, 1], ids=["K8", "K1"])
@pytest.mark.parametrize("family", ["qwen3_moe", "qwen2_moe"])
def test_llm_greedy_matches_jax(tmp_path, family, K):
    save_random(tmp_path, family, seed=11)
    jax_toks, _ = _greedy("jax", tmp_path, **_kwargs(K))
    port_toks, _ = _greedy("torch", tmp_path, **_kwargs(K))
    assert port_toks == jax_toks
    assert [len(t) for t in port_toks] == [N_OUT] * len(PROMPTS)


def test_llm_w4a16_qwen3_moe_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("TLLM_TPU_PALLAS_INTERPRET", "1")
    import torch
    from transformers import Qwen3MoeConfig, Qwen3MoeForCausalLM
    cfg = Qwen3MoeConfig(vocab_size=256, hidden_size=256,
                         intermediate_size=512, moe_intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=8,
                         num_key_value_heads=4, head_dim=32, num_experts=4,
                         num_experts_per_tok=2, norm_topk_prob=True,
                         max_position_embeddings=256,
                         tie_word_embeddings=False)
    torch.manual_seed(12)
    model = Qwen3MoeForCausalLM(cfg).float()
    with torch.no_grad():
        for layer in model.model.layers:
            layer.mlp.gate.weight.normal_(0, 0.5)
    model.save_pretrained(tmp_path, safe_serialization=True)
    ref, ref_lps = _greedy("jax", tmp_path, "W4A16_AWQ", logprobs=2,
                           **_kwargs())
    got, _ = _greedy("torch", tmp_path, "W4A16_AWQ", **_kwargs())
    assert [len(t) for t in got] == [N_OUT] * len(PROMPTS)
    agreed = 0
    for r, g, lps in zip(ref, got, ref_lps):
        for a, b, lp in zip(r, g, lps):
            if a != b:
                top = sorted(lp.values(), reverse=True)
                assert top[0] - top[1] <= 3e-2, (r, g, lp)
                break
            agreed += 1
    assert agreed >= N_OUT * len(PROMPTS) // 2


def test_eagle3_on_a_qwen3_target(tmp_path):
    import tensorrt_llm_tpu_torch as T
    save_random(tmp_path, "qwen3", seed=13)
    plain, _ = _greedy("torch", tmp_path, **_kwargs())
    llm = T.LLM(str(tmp_path), device="cpu",
                speculative_config=T.SpeculativeConfig(mode="EAGLE3",
                                                       max_draft_len=2),
                kv_cache_config=T.KvCacheConfig(tokens_per_block=16,
                                                max_tokens=1024),
                **_kwargs())
    try:
        outs = llm.generate(PROMPTS, T.SamplingParams(
            max_tokens=N_OUT, top_k=1, ignore_eos=True))
        windows = llm.engine.sd.windows
        outside = llm.executor.nonspec_decode_rows
    finally:
        llm.shutdown()
    assert [o.outputs[0].token_ids for o in outs] == plain
    assert windows > 0 and outside == 0
