"""Host drafting (NGRAM) on the DeepSeek-style and GPT-OSS targets: the
port's ``LLM.generate`` against the JAX package's, float32, CPU.

A tiny DeepSeek-V3 (MLA over the latent pool, whose verify steps take
the latent gather rather than K1/K2) and a tiny GPT-OSS (sinks and
windows of 8 that the prompts outgrow, through K2 in the verify steps)
serve prompts with repeated n-grams under ``SpeculativeConfig(mode=
"NGRAM", max_draft_len=3)``: greedy tokens equal the JAX package's and
the port's own without speculation, and the drafts accepted per verified
row equal the JAX package's.
"""
import pytest

from tests.test_torch_host_spec_llm import _run, _spec

PROMPTS = [[5, 17, 40, 3, 5, 17, 40, 3, 5], [7, 8, 9, 10] * 5]


def _target(kind):
    if kind == "deepseek_v3":
        from tests.test_torch_deepseek import _cfg, random_model
        return random_model(*_cfg("v3"), seed=7)
    from tests.test_torch_gpt_oss import random_model, tiny_cfg
    return random_model(tiny_cfg(), seed=7)


@pytest.mark.parametrize("kind", ["deepseek_v3", "gpt_oss"])
def test_ngram_target_equals_jax(kind):
    model = _target(kind)
    sp = dict(max_tokens=12, top_k=1, ignore_eos=True)
    kw = dict(max_batch_size=4, max_input_len=64, max_seq_len=128,
              max_num_tokens=128)
    spec = _spec("ngram", None)
    jt, jacc, _ = _run("jax", model, PROMPTS, sp, spec, **kw)
    tt, tacc, stats = _run("torch", model, PROMPTS, sp, spec, **kw)
    base = _run("torch", model, PROMPTS, sp, None, **kw)[0]
    assert tt == jt == base
    assert tacc == jacc
    assert stats["verify"] > 0
