"""The port's Bamba (Mamba2 + attention) and Granite-4.0-H (Mamba2 +
attention + MoE and a shared MLP, Granite's multipliers) against the JAX
package's, float32, CPU.

Each family is a tiny seeded ``transformers`` model (the configs of
tests/test_bamba.py and test_hybrid_models.py, Bamba's SSD cut into
chunks of 8 tokens). Three ragged steps (two prompts, then a decode
row beside a segment that continues a prompt, then two decode rows) give
the JAX model's logits and slot states within 2e-4, from the checkpoint
and through ``from_jax_params``; the attention layers go through the
port's attention path (K1/K2 on the card). The port's ``LLM`` gives the
JAX model's greedy tokens on three prompts over two slots, so that the
third prompt takes a recycled slot.
"""
import numpy as np
import pytest

from tests import torch_recurrent_util as U


def _configs():
    import transformers as tf
    return {
        "bamba": (tf.BambaConfig(
            vocab_size=96, hidden_size=64, intermediate_size=128,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, attn_layer_indices=[1, 3],
            mamba_n_heads=4, mamba_d_state=16, mamba_n_groups=2,
            mamba_expand=2, mamba_d_conv=4, mamba_chunk_size=8,
            max_position_embeddings=256), tf.BambaForCausalLM),
        "granitemoehybrid": (tf.GraniteMoeHybridConfig(
            vocab_size=96, hidden_size=64, intermediate_size=48,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, num_local_experts=4,
            num_experts_per_tok=2,
            layer_types=["mamba", "attention", "mamba", "attention"],
            mamba_n_heads=4, mamba_d_state=16, mamba_n_groups=2,
            mamba_expand=2, mamba_d_conv=4, shared_intermediate_size=64,
            embedding_multiplier=2.0, residual_multiplier=0.5,
            attention_multiplier=0.2, logits_scaling=3.0,
            max_position_embeddings=256), tf.GraniteMoeHybridForCausalLM),
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
