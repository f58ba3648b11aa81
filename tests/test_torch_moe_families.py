"""The port's Granite-MoE, HunYuan (dense and MoE), Seed-OSS, ERNIE 4.5
(dense and MoE), GLM-4.5 (q/k norm on and off) and Apertus against the
JAX package's, float32, CPU.

Each family is a tiny seeded ``transformers`` model (the configs of
tests/test_models_batch3.py::test_granitemoe and tests/
test_models_batch4.py, vocab 128) with its biases redrawn and, except for
HunYuan's q/k norms (below), its norms; GLM-4.5's correction bias is
drawn too. A prefill step of two ragged prompts then a decode step give
the JAX model's logits within 1e-4, from the checkpoint and through
``from_jax_params``; greedy tokens of both ``LLM``s agree on GLM-4.5.

Reference faults reproduced against ``transformers``: HunYuan applies its
q/k norms after the rotary embedding and raises its rotary base by
``rope_scaling["alpha"]``, where the JAX model norms before it and ignores
``alpha`` (both agree at unit norm weights without ``alpha``, the
configs above); GLM-4.5's router is group-limited when ``n_group`` > 1,
which the JAX model ignores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dense_families import PAGES, PS, prefill_then_decode

ATOL = 1e-4
V = 128


def _configs():
    import transformers as tf
    base = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256)
    three = dict(base, num_hidden_layers=3)
    glm = dict(n_routed_experts=4, num_experts_per_tok=2,
               moe_intermediate_size=32, n_shared_experts=1,
               first_k_dense_replace=1, head_dim=16, attention_bias=True,
               partial_rotary_factor=0.5, **three)
    return {
        "granitemoe": (tf.GraniteMoeConfig(
            num_local_experts=4, num_experts_per_tok=2,
            embedding_multiplier=6.0, attention_multiplier=0.3,
            residual_multiplier=0.22, logits_scaling=4.0,
            tie_word_embeddings=False, **dict(base, intermediate_size=96)),
            tf.GraniteMoeForCausalLM),
        "hunyuan_v1_dense": (tf.HunYuanDenseV1Config(head_dim=16, **base),
                             tf.HunYuanDenseV1ForCausalLM),
        "hunyuan_v1_moe": (tf.HunYuanMoEV1Config(
            head_dim=16, num_experts=4, moe_topk=[2, 2], **base),
            tf.HunYuanMoEV1ForCausalLM),
        "seed_oss": (tf.SeedOssConfig(head_dim=16, **base),
                     tf.SeedOssForCausalLM),
        "ernie4_5": (tf.Ernie4_5Config(head_dim=16, use_bias=True, **base),
                     tf.Ernie4_5ForCausalLM),
        "ernie4_5_moe": (tf.Ernie4_5_MoeConfig(
            head_dim=16, moe_num_experts=4, moe_k=2,
            moe_intermediate_size=32, moe_num_shared_experts=1,
            moe_layer_start_index=1, **three), tf.Ernie4_5_MoeForCausalLM),
        "glm4_moe": (tf.Glm4MoeConfig(use_qk_norm=False, **glm),
                     tf.Glm4MoeForCausalLM),
        "glm4_moe_qk_norm": (tf.Glm4MoeConfig(use_qk_norm=True, **glm),
                             tf.Glm4MoeForCausalLM),
        "apertus": (tf.ApertusConfig(**base), tf.ApertusForCausalLM),
    }


FAMILIES = list(_configs())


def random_model(family, seed=0, config=None, qk_norms=False):
    """A seeded float32 ``transformers`` model of ``family`` (or of
    ``config``) with its biases, its norms (HunYuan's q/k norms only with
    ``qk_norms``) and GLM's correction bias redrawn."""
    cfg, cls = _configs()[family]
    cfg = config or cfg
    torch.manual_seed(seed)
    model = cls(cfg).float().eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
            elif "norm" in name and (qk_norms or not any(
                    k in name for k in ("query_layernorm", "key_layernorm"))):
                p.copy_(1 + torch.randn(p.shape, generator=gen) * 0.1)
        for name, b in model.named_buffers():
            if name.endswith("e_score_correction_bias"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
    return cfg, model


def _sd(model):
    return {k: v.detach().float().numpy().copy()
            for k, v in model.state_dict().items()}


def _models(cfg, sd):
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu_torch.models import ModelConfig as TConfig
    from tensorrt_llm_tpu_torch.models import get_model_class as tget
    jm = jget(cfg.model_type)(JConfig(hf_config=cfg, dtype=jnp.float32))
    tm = tget(cfg.model_type)(TConfig(hf_config=cfg, dtype=torch.float32,
                                      device="cpu"))
    return jm, jm.load_hf_state_dict(dict(sd)), tm, \
        tm.load_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    from tensorrt_llm_tpu_torch.models import from_jax_params
    cfg, hf = random_model(request.param)
    jm, jparams, tm, tparams = _models(cfg, _sd(hf))
    return jm, jparams, tm, {
        "safetensors": tparams,
        "from_jax_params": from_jax_params(jax.tree.map(np.asarray,
                                                        jparams))}


@pytest.mark.parametrize("load", ["safetensors", "from_jax_params"])
def test_prefill_then_decode_match_jax(family, load):
    jm, jparams, tm, tparams = family
    want, got = prefill_then_decode(jm, jparams, tm, tparams[load])
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0.05
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_knobs_and_layers_as_the_jax_models_set_them(family):
    """The attention's scale and rotary style, the multipliers, and the
    layers' kinds (dense before ``first_k_dense_replace``, MoE after; the
    shared expert ungated), with the same parameter names whichever way
    the weights came in."""
    jm, jparams, tm, tparams = family
    assert tm.attn_spec.sm_scale == pytest.approx(jm.attn_spec.sm_scale)
    assert tm.attn_spec.is_neox == jm.attn_spec.is_neox
    for knob in ("embedding_multiplier", "residual_multiplier",
                 "logits_scaling"):
        assert getattr(tm, knob) == getattr(jm, knob, 1.0), knob
    layers = tparams["safetensors"]["layers"]
    if "moe_layers" in jparams:
        dense = jparams["dense_layers"]
        n_dense = 0 if dense is None else len(dense["input_norm"])
    else:
        n_dense = 0 if "router" in jparams["layers"] else len(layers)
    assert [("router" in lay) for lay in layers] == \
        [i >= n_dense for i in range(len(layers))]
    assert not any("se_gate_w" in lay for lay in layers)
    for a, b in zip(layers, tparams["from_jax_params"]["layers"]):
        assert set(a) == set(b)


def test_llm_greedy_matches_jax_on_glm4_moe():
    """Greedy tokens of the port's ``LLM`` equal the JAX ``LLM``'s on the
    tiny GLM-4.5 (q/k norms on), served from the ``transformers``
    module."""
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    from tests.test_torch_dense_families import PROMPTS
    _, hf = random_model("glm4_moe_qk_norm", seed=3)
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=64, max_seq_len=128, max_num_tokens=128)
    outs = []
    for pkg, extra in ((T, {"device": "cpu"}), (J, {})):
        llm = pkg.LLM(hf, kv_cache_config=pkg.KvCacheConfig(
            tokens_per_block=PS, max_tokens=1024), **kw, **extra)
        try:
            res = llm.generate(PROMPTS, pkg.SamplingParams(max_tokens=12,
                                                           top_k=1))
            outs.append([r.outputs[0].token_ids for r in res])
        finally:
            llm.shutdown()
    assert [len(t) for t in outs[0]] == [12] * 3
    assert outs[0] == outs[1]


# --------------------------------------------------------------------- #
# Reference faults (ROADMAP C)
# --------------------------------------------------------------------- #
def _prefill_logits(tm, params, toks):
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    t = torch.from_numpy
    T = len(toks)
    pos = np.arange(T, dtype=np.int32)
    md = tattn.AttentionMetadata(
        kv_lens=t(np.asarray([T], np.int32)),
        page_indices=t(np.arange(PAGES, dtype=np.int32)[None]),
        cu_q_lens=t(np.asarray([0, T], np.int32)),
        num_seqs=t(np.asarray([1], np.int32)), slot_mapping=t(pos),
        positions=t(pos), logits_indices=t(np.asarray([T - 1], np.int32)))
    return tm.forward(params, t(np.asarray(toks)).long(),
                      tm.make_kv_pages(PAGES, PS), md)[0][0].numpy()


def _jax_prefill_logits(jm, jparams, toks):
    from tests.test_models import make_prefill_metadata
    jl, _ = jm.forward(jparams, jnp.asarray(toks, jnp.int32),
                       jm.make_kv_pages(PAGES, PS),
                       make_prefill_metadata(jm, len(toks)))
    return np.asarray(jl)[0]


def _against_transformers(cfg, hf):
    """(port's error, JAX's error) against the ``transformers`` model's
    last logits of a 40-token prompt."""
    jm, jparams, tm, tparams = _models(cfg, _sd(hf))
    toks = np.random.default_rng(9).integers(0, V, 40)
    with torch.no_grad():
        ref = hf(torch.tensor([toks.tolist()])).logits[0, -1].numpy()
    return (np.abs(_prefill_logits(tm, tparams, toks) - ref).max(),
            np.abs(_jax_prefill_logits(jm, jparams, toks) - ref).max())


@pytest.mark.parametrize("family,fault", [
    ("hunyuan_v1_dense", "qk_norms"), ("hunyuan_v1_dense", "alpha"),
    ("hunyuan_v1_moe", "qk_norms")])
def test_hunyuan_follows_transformers(family, fault):
    """HunYuan with q/k norm weights that are not 1 (q/k norms after the
    rotary embedding), or with ``rope_scaling`` alpha 1000 (the published
    configs' DynamicNTKAlpha base): the port gives transformers' logits,
    the JAX model does not."""
    import copy
    cfg = copy.deepcopy(_configs()[family][0])
    if fault == "alpha":
        cfg.rope_scaling = {"type": "dynamic", "alpha": 1000.0,
                            "factor": 1.0}
    _, hf = random_model(family, seed=2, config=cfg,
                         qk_norms=fault == "qk_norms")
    port_err, jax_err = _against_transformers(cfg, hf)
    assert port_err < ATOL
    assert jax_err > max(100 * port_err, 5 * ATOL)


def test_glm4_moe_group_limit_follows_transformers():
    """GLM-4.5 with ``n_group`` 2, ``topk_group`` 1: the port limits the
    experts to the best group as transformers' router does; the JAX model
    routes over all experts."""
    import copy
    cfg = copy.deepcopy(_configs()["glm4_moe"][0])
    cfg.n_group, cfg.topk_group = 2, 1
    _, hf = random_model("glm4_moe", seed=6, config=cfg)
    port_err, jax_err = _against_transformers(cfg, hf)
    assert port_err < ATOL
    assert jax_err > max(100 * port_err, 5 * ATOL)


def test_routers_match_transformers():
    """GLM-4.5's router (sigmoid, correction bias, group limit) and
    ERNIE 4.5's gate (softmax, bias-corrected choice, clamped
    renormalisation) choose and weigh as transformers' blocks do."""
    import transformers as tf
    from tensorrt_llm_tpu_torch.ops.moe import (sigmoid_bias_routing,
                                                softmax_bias_routing)
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(16, 64, generator=gen)
    cfg = tf.Glm4MoeConfig(hidden_size=64, n_routed_experts=8,
                           num_experts_per_tok=3, n_group=4, topk_group=2,
                           norm_topk_prob=True, routed_scaling_factor=2.5)
    router = tf.models.glm4_moe.modeling_glm4_moe.Glm4MoeTopkRouter(cfg)
    with torch.no_grad():
        router.weight.copy_(torch.randn(8, 64, generator=gen))
        router.e_score_correction_bias.copy_(torch.randn(8, generator=gen)
                                             * 0.1)
        idx, w = router(x[None])
    pw, pidx = sigmoid_bias_routing(x @ router.weight.t(),
                                    router.e_score_correction_bias, 3, True,
                                    2.5, 4, 2)
    assert torch.equal(torch.sort(pidx.long(), -1)[0], torch.sort(idx, -1)[0])
    torch.testing.assert_close(torch.sort(pw, -1)[0], torch.sort(w, -1)[0])
    ecfg = tf.Ernie4_5_MoeConfig(hidden_size=64, moe_num_experts=8, moe_k=3,
                                 moe_norm_min=1e-12)
    stat = tf.models.ernie4_5_moe.modeling_ernie4_5_moe.Ernie4_5_MoeStatics(
        ecfg)
    logits = torch.randn(16, 8, generator=gen)
    with torch.no_grad():
        stat.e_score_correction_bias.copy_(torch.randn(1, 8, generator=gen)
                                           * 0.1)
        probs = torch.softmax(logits, -1)
        sel = torch.topk(stat(probs), 3, dim=-1)[1]
        want = torch.gather(probs, 1, sel)
        want = want / want.sum(-1, keepdim=True).clamp(min=1e-12)
    pw, pidx = softmax_bias_routing(logits, stat.e_score_correction_bias
                                    .reshape(-1), 3, 1e-12)
    assert torch.equal(pidx.long(), sel)
    torch.testing.assert_close(pw, want)


# --------------------------------------------------------------------- #
# Refusals by name
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("family,change,match", [
    ("ernie4_5_moe", {"use_bias": True}, "use_bias"),
    ("ernie4_5_moe", {"moe_layer_interval": 2}, "moe_layer_interval"),
    ("hunyuan_v1_moe", {"moe_topk": [2, 1]}, "moe_topk"),
    ("hunyuan_v1_moe", {"num_experts": [4, 8]}, "num_experts")])
def test_options_the_jax_package_serves_otherwise_are_refused(family, change,
                                                              match):
    import copy
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    cfg = copy.deepcopy(_configs()[family][0])
    for k, v in change.items():
        setattr(cfg, k, v)
    with pytest.raises(NotImplementedError, match=match):
        get_model_class(cfg.model_type)(ModelConfig(
            hf_config=cfg, dtype=torch.float32, device="cpu"))


@pytest.mark.parametrize("model_type", [
    "granitemoe", "hunyuan_v1_moe", "glm4_moe", "ernie4_5_moe", "apertus",
    "deepseek_v2", "deepseek_v3", "longcat_flash"])
def test_eagle3_refused_by_name(model_type):
    from tensorrt_llm_tpu_torch.llmapi.llm_args import (SpeculativeConfig,
                                                        check_ported_spec)
    with pytest.raises(NotImplementedError, match=model_type):
        check_ported_spec(SpeculativeConfig(mode="EAGLE3", max_draft_len=2),
                          model_type)


@pytest.mark.parametrize("model_type", [
    "gemma3", "gemma3_vl", "glm4v", "mllama", "paligemma", "qwen2_vl",
    "qwen2_5_vl", "qwen3_vl", "qwen3_vl_moe"])
def test_unported_model_types_refused_by_name(model_type):
    from tensorrt_llm_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from tensorrt_llm_tpu_torch.models import get_model_class
    assert model_type in JAX_REGISTRY
    with pytest.raises(NotImplementedError, match=model_type):
        get_model_class(model_type)
