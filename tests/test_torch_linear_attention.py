"""The port's Qwen3-Next (gated DeltaNet + gated attention + MoE) and
MiniMax (lightning attention as an SSD scan + attention + MoE) against
the JAX package's, float32, CPU.

Each family is a tiny seeded ``transformers`` model (the configs of
tests/test_qwen3_next.py and test_minimax.py). Three ragged steps (two
prompts, then a decode row beside a segment that continues a prompt,
then two decode rows) give the JAX model's logits and slot states within
2e-4, from the checkpoint and through ``from_jax_params``; the port's
``LLM`` gives the JAX model's greedy tokens on three prompts over two
slots. The steps hold no padding tokens: the JAX delta rule writes a
padding token's update into slot 0 (ROADMAP "Reference faults"), where
the port's goes to the trash slot (tests/test_torch_ssm.py).
"""
import numpy as np
import pytest

from tests import torch_recurrent_util as U


def _configs():
    import transformers as tf
    return {
        "qwen3_next": (tf.Qwen3NextConfig(
            vocab_size=96, hidden_size=64, intermediate_size=128,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, linear_num_value_heads=4,
            linear_num_key_heads=2, linear_key_head_dim=8,
            linear_value_head_dim=8, linear_conv_kernel_dim=4,
            num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
            shared_expert_intermediate_size=32, decoder_sparse_step=1,
            max_position_embeddings=256), tf.Qwen3NextForCausalLM),
        "minimax": (tf.MiniMaxConfig(
            vocab_size=96, hidden_size=64, intermediate_size=128,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, num_local_experts=4,
            num_experts_per_tok=2,
            layer_types=["linear_attention", "full_attention"] * 2,
            head_dim=16, max_position_embeddings=256, block_size=8),
            tf.MiniMaxForCausalLM),
    }


FAMILIES = list(_configs())


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    cfg, cls = _configs()[request.param]
    hf = U.random_hf(cfg, cls)
    jm, jp, tm, tp = U.models(cfg, U.state_dict(hf))
    return cfg, hf, jm, jp, tm, tp


@pytest.mark.parametrize("load", ["safetensors", "from_jax_params"])
def test_three_steps_match_jax(family, load):
    from tensorrt_llm_tpu_torch.models import from_jax_params
    cfg, _, jm, jp, tm, tp = family
    if load == "from_jax_params":
        tp = from_jax_params(U.jax_tree_np(jp), model=tm)
    U.check_three_steps(jm, jp, tm, tp, cfg.vocab_size)


def test_llm_greedy_matches_jax(family):
    cfg, hf, jm, jp, _, _ = family
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=6))
               for _ in range(3)]
    U.check_llm_matches_jax(jm, jp, hf, prompts, max_batch_size=2)
