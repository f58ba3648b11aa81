"""Greedy tokens of the port's ``LLM`` against the JAX package's on a tiny
GPT-OSS (float32, CPU): sinks, alternating windows of 8 that the prompts
outgrow, the biased clamped-SwiGLU experts; from the ``transformers``
module (both packages' inline entry) and from MXFP4 blocks and scales in
a checkpoint directory."""
from tests.test_torch_dense_families import PROMPTS
from tests.test_torch_gpt_oss import random_model, tiny_cfg, to_mxfp4

SETTINGS = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
                max_input_len=64, max_seq_len=128, max_num_tokens=128)
PROMPTS_V = [[t % 96 for t in p] for p in PROMPTS]


def greedy(pkg, model, n=12, **extra):
    llm = pkg.LLM(model, kv_cache_config=pkg.KvCacheConfig(
        tokens_per_block=16, max_tokens=1024), **SETTINGS, **extra)
    try:
        res = llm.generate(PROMPTS_V, pkg.SamplingParams(max_tokens=n,
                                                         top_k=1))
        return [r.outputs[0].token_ids for r in res]
    finally:
        llm.shutdown()


def test_llm_greedy_matches_jax():
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    hf = random_model(tiny_cfg(), seed=3)
    got = greedy(T, hf, device="cpu")
    assert [len(t) for t in got] == [12] * 3
    assert got == greedy(J, hf)


def test_llm_serves_an_mxfp4_checkpoint_directory(tmp_path):
    """A checkpoint directory whose experts are MXFP4 blocks and scales
    (the release format): the port's ``LLM`` serves it with the tokens of
    the JAX ``LLM`` given the same directory."""
    from safetensors.numpy import save_file
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    cfg = tiny_cfg()
    hf = random_model(cfg, seed=5)
    sd = {k: v.detach().float().numpy().copy()
          for k, v in hf.state_dict().items()}
    sdq = to_mxfp4(sd, cfg.num_hidden_layers)
    assert "model.layers.0.mlp.experts.gate_up_proj" not in sdq
    save_file(sdq, str(tmp_path / "model.safetensors"))
    cfg.save_pretrained(tmp_path)
    got = greedy(T, str(tmp_path), device="cpu")
    assert got == greedy(J, str(tmp_path))
