"""The port's Llama-derived dense families against the JAX package's,
float32, CPU: Granite, OLMo 2, Phi-3, GLM, GLM-4, EXAONE 4 (with and
without sliding layers), SmolLM3, Helium and Arcee.

Each family is a tiny seeded ``transformers`` model (the configs of
tests/test_models_extra.py and tests/test_models_batch3.py) saved to a
temporary directory, with its norms and biases redrawn so that they
matter. Both packages load the directory; the port also takes the JAX
parameter tree through ``from_jax_params``. A prefill step of two ragged
prompts (11 and 23 tokens, so that EXAONE 4's window of 8 cuts), then a
decode step: logits agree within 1e-4 (float32 sums in another order).
Greedy tokens through both ``LLM``s are identical for one family per
knob of the Llama base: post norms (OLMo 2), sandwich norms (GLM-4), the
relu MLP (Arcee), NoPE layers (SmolLM3) and per-layer windows with rope
on the sliding layers only (EXAONE 4). Phi-3-mini's head dim 96 is
served on the CPU here, and on the card
(tests/test_torch_cuda_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ATOL = 1e-4
PS, PAGES, V = 16, 8, 128


def _configs():
    import transformers as tf
    base = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256,
                tie_word_embeddings=False)
    ids = dict(pad_token_id=0, eos_token_id=1, bos_token_id=2)
    return {
        "granite": (tf.GraniteConfig(embedding_multiplier=12.0,
                                     attention_multiplier=0.03,
                                     residual_multiplier=0.22,
                                     logits_scaling=8.0, **base),
                    tf.GraniteForCausalLM),
        "olmo2": (tf.Olmo2Config(**base), tf.Olmo2ForCausalLM),
        "phi3": (tf.Phi3Config(**ids, **base), tf.Phi3ForCausalLM),
        "glm": (tf.GlmConfig(head_dim=16, partial_rotary_factor=0.5,
                             attention_bias=True, **ids, **base),
                tf.GlmForCausalLM),
        "glm4": (tf.Glm4Config(head_dim=16, partial_rotary_factor=0.5,
                               attention_bias=True, **ids, **base),
                 tf.Glm4ForCausalLM),
        "exaone4": (tf.Exaone4Config(
            head_dim=16, sliding_window=8, sliding_window_pattern=4,
            **ids, **dict(base, num_hidden_layers=5)),
            tf.Exaone4ForCausalLM),
        "exaone4_global": (tf.Exaone4Config(
            head_dim=16, sliding_window=None,
            layer_types=["full_attention"] * 2, **ids, **base),
            tf.Exaone4ForCausalLM),
        "smollm3": (tf.SmolLM3Config(
            no_rope_layers=[1, 1, 1, 0], **ids,
            **dict(base, num_hidden_layers=4)), tf.SmolLM3ForCausalLM),
        "helium": (tf.HeliumConfig(head_dim=16, **ids, **base),
                   tf.HeliumForCausalLM),
        "arcee": (tf.ArceeConfig(**ids, **base), tf.ArceeForCausalLM),
    }


FAMILIES = list(_configs())


def save_random(path, family, seed=0, config=None):
    """A seeded random ``transformers`` model of ``family`` (or of
    ``config``) saved to ``path``, with its norms near 1 and its biases
    redrawn; returns (config, the torch model)."""
    cfg, cls = _configs()[family]
    cfg = config or cfg
    torch.manual_seed(seed)
    model = cls(cfg).float().eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
            elif "norm" in name:
                p.copy_(1 + torch.randn(p.shape, generator=gen) * 0.1)
    model.save_pretrained(path, safe_serialization=True)
    return cfg, model


@pytest.fixture(scope="module", params=FAMILIES)
def family(request, tmp_path_factory):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file

    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu_torch.models import ModelConfig as TConfig
    from tensorrt_llm_tpu_torch.models import from_jax_params
    from tensorrt_llm_tpu_torch.models import get_model_class as tget

    path = tmp_path_factory.mktemp(request.param)
    cfg, _ = save_random(path, request.param)
    st = str(path / "model.safetensors")
    jm = jget(cfg.model_type)(JConfig(hf_config=cfg, dtype=jnp.float32))
    jparams = jm.load_hf_state_dict(dict(np_load(st)))
    tm = tget(cfg.model_type)(TConfig(hf_config=cfg, dtype=torch.float32,
                                      device="cpu"))
    return jm, jparams, tm, {
        "from_jax_params": from_jax_params(jax.tree.map(np.asarray,
                                                        jparams)),
        "safetensors": tm.load_hf_state_dict(load_file(st))}


def _md(mod, tensor, kv_lens, pages, cu, slots, pos, logits_idx):
    return mod.AttentionMetadata(
        kv_lens=tensor(np.asarray(kv_lens, np.int32)),
        page_indices=tensor(pages), cu_q_lens=tensor(cu),
        num_seqs=tensor(np.asarray([2], np.int32)),
        slot_mapping=tensor(slots), positions=tensor(pos),
        logits_indices=tensor(np.asarray(logits_idx, np.int32)))


def prefill_then_decode(jm, jparams, tm, params, vocab=V):
    """Logits of both models on a prefill step of prompts of 11 and 23
    tokens (pages 0-1 and 2-3) and on the decode step that follows:
    ((JAX prefill, JAX decode), (port prefill, port decode))."""
    from tensorrt_llm_tpu.ops import attention as jattn
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    rng = np.random.default_rng(0)
    lens = [11, 23]
    pages = np.array([[0, 1] + [0] * (PAGES - 2),
                      [2, 3] + [0] * (PAGES - 2)], np.int32)
    toks = rng.integers(0, vocab, size=sum(lens)).astype(np.int32)
    pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    seq = np.repeat([0, 1], lens)
    slots = (pages[seq, pos // PS] * PS + pos % PS).astype(np.int32)
    cu = np.array([0, 11, 34], np.int32)
    t = torch.from_numpy
    jpool, tpool = jm.make_kv_pages(PAGES, PS), tm.make_kv_pages(PAGES, PS)
    jl, jpool = jm.forward(jparams, jnp.asarray(toks), jpool, _md(
        jattn, jnp.asarray, lens, pages, cu, slots, pos, [10, 33]))
    tl, tpool = tm.forward(params, t(toks).long(), tpool, _md(
        tattn, t, lens, pages, cu, slots, pos, [10, 33]))
    nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
    dpos = np.array(lens, np.int32)
    dslots = (pages[[0, 1], dpos // PS] * PS + dpos % PS).astype(np.int32)
    dcu = np.array([0, 1, 2], np.int32)
    kv = [n + 1 for n in lens]
    jl2, _ = jm.forward(jparams, jnp.asarray(nxt), jpool, _md(
        jattn, jnp.asarray, kv, pages, dcu, dslots, dpos, [0, 1]))
    tl2, _ = tm.forward(params, t(nxt).long(), tpool, _md(
        tattn, t, kv, pages, dcu, dslots, dpos, [0, 1]))
    return (np.asarray(jl), np.asarray(jl2)), (tl.numpy(), tl2.numpy())


@pytest.mark.parametrize("load", ["from_jax_params", "safetensors"])
def test_prefill_then_decode_match_jax(family, load):
    jm, jparams, tm, tparams = family
    want, got = prefill_then_decode(jm, jparams, tm, tparams[load])
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0.05
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_knobs_are_set_as_the_jax_models_set_them(family):
    jm, _, tm, _ = family
    for knob in ("norm_placement", "embedding_multiplier",
                 "residual_multiplier", "logits_scaling", "mlp_act",
                 "use_qk_norm", "qk_norm_full"):
        assert getattr(tm, knob) == getattr(jm, knob), knob
    assert tm.attn_spec.sm_scale == pytest.approx(jm.attn_spec.sm_scale)
    assert tm.attn_spec.is_neox == jm.attn_spec.is_neox


def test_per_layer_specs():
    """EXAONE 4: window and rope on the sliding layers, neither on the
    global ones; SmolLM3: no rope on its NoPE layers; the engine's split
    keys see both of EXAONE 4's windows."""
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    cfgs = _configs()
    ex = get_model_class("exaone4")(ModelConfig(
        hf_config=cfgs["exaone4"][0], dtype=torch.float32, device="cpu"))
    specs = ex.layer_specs
    assert [s.sliding_window for s in specs] == [8, 8, 8, None, 8]
    assert [s.rope is not None for s in specs] == [True] * 3 + [False, True]
    assert ex.attention_windows() == (8, None)
    sm = get_model_class("smollm3")(ModelConfig(
        hf_config=cfgs["smollm3"][0], dtype=torch.float32, device="cpu"))
    assert [s.rope is not None for s in sm.layer_specs] == \
        [True, True, True, False]
    assert sm.attention_windows() == (None,)


# --------------------------------------------------------------------- #
# LLM
# --------------------------------------------------------------------- #
PROMPTS = [[5, 17, 99, 4, 61, 7, 3, 120, 44, 8, 9],
           [1 + (7 * i) % 120 for i in range(23)], [7, 3, 99, 4, 61]]


def greedy_both(path, n=12, jax_extra=None, torch_extra=None):
    """Greedy tokens of PROMPTS through both packages' ``LLM``."""
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    out = {}
    for name, pkg, extra in (("jax", J, jax_extra or {}),
                             ("torch", T, dict(device="cpu",
                                               **(torch_extra or {})))):
        llm = pkg.LLM(path, skip_tokenizer_init=True, dtype="float32",
                      max_batch_size=4, max_input_len=64, max_seq_len=128,
                      max_num_tokens=128, kv_cache_config=pkg.KvCacheConfig(
                          tokens_per_block=16, max_tokens=1024), **extra)
        try:
            res = llm.generate(PROMPTS, pkg.SamplingParams(max_tokens=n,
                                                           top_k=1))
            out[name] = [r.outputs[0].token_ids for r in res]
        finally:
            llm.shutdown()
    return out


@pytest.mark.parametrize("knob", ["olmo2", "glm4", "arcee", "smollm3",
                                  "exaone4"])
def test_llm_greedy_matches_jax(tmp_path, knob):
    save_random(tmp_path, knob, seed=3)
    out = greedy_both(str(tmp_path))
    assert [len(t) for t in out["torch"]] == [12] * 3
    assert out["torch"] == out["jax"]


def test_phi3_mini_head_dim_96_on_the_cpu(tmp_path):
    """Phi-3-mini's geometry in small: head dim 96 (hidden 192 over 2
    heads). The CPU serves it and matches the JAX model."""
    import transformers as tf

    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file

    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu_torch.models import ModelConfig as TConfig
    from tensorrt_llm_tpu_torch.models import get_model_class as tget
    cfg = tf.Phi3Config(vocab_size=V, hidden_size=192, intermediate_size=256,
                        num_hidden_layers=2, num_attention_heads=2,
                        num_key_value_heads=2, max_position_embeddings=256,
                        tie_word_embeddings=False, pad_token_id=0,
                        eos_token_id=1, bos_token_id=2)
    save_random(tmp_path, "phi3", config=cfg)
    st = str(tmp_path / "model.safetensors")
    jm = jget("phi3")(JConfig(hf_config=cfg, dtype=jnp.float32))
    tm = tget("phi3")(TConfig(hf_config=cfg, dtype=torch.float32,
                              device="cpu"))
    assert tm.head_dim == 96
    want, got = prefill_then_decode(jm, jm.load_hf_state_dict(
        dict(np_load(st))), tm, tm.load_hf_state_dict(load_file(st)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
