"""The port's Zamba2 (Mamba2 + shared attention blocks with per-use
adapters), Jamba (Mamba-1 + attention, MoE every other layer) and LFM2
(short convs + attention) against the JAX package's, float32, CPU
(Bamba and Granite-4.0-H: tests/test_torch_bamba.py).

Each family is a tiny seeded ``transformers`` model (the configs of
tests/test_hybrid_models.py and test_jamba.py; Zamba2 at 4 layers, two
of them hybrid, one per shared block; Jamba at one period of 8
layers). Three ragged steps (two prompts, then a decode
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
        "zamba2": (tf.Zamba2Config(
            vocab_size=96, hidden_size=64, intermediate_size=128,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=4, mamba_d_state=16, mamba_ngroups=1,
            mamba_expand=2, mamba_d_conv=4, n_mamba_heads=4,
            layers_block_type=["mamba", "hybrid", "mamba", "hybrid"],
            num_mem_blocks=2, use_mem_rope=True,
            use_shared_attention_adapter=True, adapter_rank=8,
            max_position_embeddings=256), tf.Zamba2ForCausalLM),
        "jamba": (tf.JambaConfig(
            vocab_size=96, hidden_size=64, intermediate_size=128,
            num_hidden_layers=8, num_attention_heads=4,
            num_key_value_heads=2, num_experts=4, num_experts_per_tok=2,
            mamba_d_state=8, mamba_d_conv=4, mamba_expand=2,
            mamba_dt_rank=8, use_mamba_kernels=False,
            max_position_embeddings=256, tie_word_embeddings=False),
            tf.JambaForCausalLM),
        "lfm2": (tf.Lfm2Config(
            vocab_size=96, hidden_size=64, intermediate_size=128,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2,
            layer_types=["conv", "full_attention", "conv",
                         "full_attention"],
            conv_L_cache=3, max_position_embeddings=16384,
            block_ff_dim=256), tf.Lfm2ForCausalLM),
    }


FAMILIES = list(_configs())


def _jamba_view(name, pool):
    """The JAX Jamba's pools are [periods, mamba layers, slots, ...]."""
    return pool.reshape((-1,) + pool.shape[2:])


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
    U.check_three_steps(jm, jp, tm, tp, cfg.vocab_size,
                        _jamba_view if cfg.model_type == "jamba" else None)


def test_llm_greedy_matches_jax(family):
    cfg, hf, jm, jp, _, _ = family
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=6))
               for _ in range(3)]
    U.check_llm_matches_jax(jm, jp, hf, prompts, max_batch_size=2)


def test_zamba2_grouped_gate_norm_follows_transformers():
    """Reference fault: at ``mamba_ngroups`` > 1 transformers' Zamba2
    normalises the mixer's gated output per group of channels, the JAX
    model over all of them (its ``mamba2_mixer``); the port follows
    transformers (models/mamba2.py ``norm_group``)."""
    import copy

    import torch
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    cfg, cls = _configs()["zamba2"]
    cfg = copy.deepcopy(cfg)
    cfg.mamba_ngroups = 2
    hf = U.random_hf(cfg, cls, seed=3)
    inner = cfg.mamba_expand * cfg.hidden_size
    with torch.no_grad():
        for n, p in hf.named_parameters():
            if n.endswith("mamba.in_proj.weight"):
                # the second group's x channels 5x the first's: the two
                # groups' RMS differ
                p[inner + inner // 2:2 * inner] *= 5.0
    sd = U.state_dict(hf)
    tm = get_model_class("zamba2")(ModelConfig(
        hf_config=cfg, dtype=torch.float32, device="cpu"))
    tp = tm.load_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    toks = list(range(3, 20))
    step = U.Step([toks], [0], [0], [[0, 1]])
    got, _ = step.port(tm, tp, tm.make_kv_pages(U.PAGES, U.PS, num_slots=2))
    with torch.no_grad():
        want = hf(torch.tensor([toks])).logits[0, -1].numpy()
    np.testing.assert_allclose(got[0], want, atol=2e-4, rtol=0)
    jm, jp, _, _ = U.models(cfg, sd)
    jl, _ = step.jax(jm, jp, jm.make_kv_pages(U.PAGES, U.PS))
    assert np.abs(jl[0] - want).max() > 20 * U.ATOL
