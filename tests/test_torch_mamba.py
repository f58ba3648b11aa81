"""The port's Mamba, FalconMamba and Mamba2 against the JAX package's,
float32, CPU.

Each family is a tiny seeded ``transformers`` model (the configs of
tests/test_mamba.py, test_hybrid_models.py and test_mamba2.py, whose
Mamba2 cuts its SSD into chunks of 8 tokens). Three ragged steps (two
prompts, then a decode row beside a segment that continues a prompt,
then two decode rows) give the JAX model's logits and slot states within
1e-4 to 2e-4, from the checkpoint and through ``from_jax_params``; the
port's ``LLM`` gives the JAX model's greedy tokens on prompts that
outnumber its slots, so that later prompts take recycled slots.
"""
import numpy as np
import pytest

from tests import torch_recurrent_util as U


def _configs():
    import transformers as tf
    mamba = dict(vocab_size=96, hidden_size=64, state_size=8,
                 num_hidden_layers=2, conv_kernel=4, expand=2,
                 time_step_rank=4)
    return {
        "mamba": (tf.MambaConfig(**mamba), tf.MambaForCausalLM),
        "falcon_mamba": (tf.FalconMambaConfig(**mamba),
                         tf.FalconMambaForCausalLM),
        "mamba2": (tf.Mamba2Config(
            vocab_size=96, hidden_size=64, state_size=16,
            num_hidden_layers=2, conv_kernel=4, expand=2, num_heads=4,
            head_dim=32, n_groups=2, chunk_size=8), tf.Mamba2ForCausalLM),
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
