"""The port's LayerNorm GPT families and GPT-2 against the JAX package's,
float32, CPU: GPT-2, GPT-NeoX (parallel and sequential), GPT-J, Falcon
(7B's one norm and the new decoder's two), StarCoder2, Cohere, Nemotron,
Cohere2, StableLM, BLOOM, MPT and OPT.

Each family is a tiny seeded ``transformers`` model (the configs of
tests/test_models.py, test_models_extra.py and test_models_batch3.py)
saved to a temporary directory, with its norms and biases redrawn so that
they matter. Both packages load the directory; the port also takes the
JAX parameter tree through ``from_jax_params``. A prefill step of two
ragged prompts (11 and 23 tokens: StarCoder2's window of 16 and Cohere2's
of 8 cut), then a decode step: logits agree within 1e-4 (float32 sums in
another order).

The JAX reference has two faults the port does not copy (ROADMAP C):
GPT-J's and Cohere's rotary embedding rotates halves there (its
``AttentionSpec.is_neox`` stays True) where the checkpoints rotate
interleaved pairs, and its "gelu" is ``jax.nn.gelu``'s tanh approximation
where GPT-NeoX, Falcon and MPT use the exact GELU. The parity tests hold
the port against a JAX model with both corrected (``_correct``);
``test_reference_faults_show_against_transformers`` shows each fault
against the ``transformers`` model, which the port matches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dense_families import PAGES, PS, V, prefill_then_decode

ATOL = 1e-4


def _configs():
    import transformers as tf
    ids = dict(pad_token_id=0, eos_token_id=1, bos_token_id=2)
    return {
        "gpt2": (tf.GPT2Config(vocab_size=V, n_positions=128, n_embd=64,
                               n_layer=2, n_head=4), tf.GPT2LMHeadModel),
        "gpt_neox": (tf.GPTNeoXConfig(
            vocab_size=V, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=256, rotary_pct=0.5,
            use_parallel_residual=True), tf.GPTNeoXForCausalLM),
        "gpt_neox_seq": (tf.GPTNeoXConfig(
            vocab_size=V, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=256, rotary_pct=1.0,
            use_parallel_residual=False), tf.GPTNeoXForCausalLM),
        "gptj": (tf.GPTJConfig(vocab_size=V, n_embd=64, n_layer=2, n_head=4,
                               n_positions=256, rotary_dim=8),
                 tf.GPTJForCausalLM),
        "falcon": (tf.FalconConfig(
            vocab_size=V, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, multi_query=True, parallel_attn=True,
            bias=False, new_decoder_architecture=False,
            max_position_embeddings=256), tf.FalconForCausalLM),
        "falcon_new": (tf.FalconConfig(
            vocab_size=V, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_kv_heads=2,
            new_decoder_architecture=True, max_position_embeddings=256),
            tf.FalconForCausalLM),
        "starcoder2": (tf.Starcoder2Config(
            vocab_size=V, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256,
            sliding_window=16, tie_word_embeddings=False),
            tf.Starcoder2ForCausalLM),
        "cohere": (tf.CohereConfig(
            vocab_size=V, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=4, max_position_embeddings=256,
            logit_scale=0.25, use_qk_norm=False), tf.CohereForCausalLM),
        "nemotron": (tf.NemotronConfig(
            vocab_size=V, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256,
            partial_rotary_factor=0.5, tie_word_embeddings=False),
            tf.NemotronForCausalLM),
        "cohere2": (tf.Cohere2Config(
            vocab_size=V, hidden_size=64, intermediate_size=128,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=4, head_dim=16, sliding_window=8,
            sliding_window_pattern=4, logit_scale=0.25,
            max_position_embeddings=256, **ids), tf.Cohere2ForCausalLM),
        "stablelm": (tf.StableLmConfig(
            vocab_size=V, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, partial_rotary_factor=0.25,
            max_position_embeddings=256, tie_word_embeddings=False, **ids),
            tf.StableLmForCausalLM),
        "bloom": (tf.BloomConfig(vocab_size=V, hidden_size=64, n_head=4,
                                 n_layer=2, **ids), tf.BloomForCausalLM),
        "mpt": (tf.MptConfig(vocab_size=V, d_model=64, n_heads=4,
                             n_layers=2, expansion_ratio=2,
                             max_seq_len=256), tf.MptForCausalLM),
        "opt": (tf.OPTConfig(vocab_size=V, hidden_size=64, ffn_dim=128,
                             num_hidden_layers=2, num_attention_heads=4,
                             max_position_embeddings=256,
                             word_embed_proj_dim=64,
                             do_layer_norm_before=True, **ids),
                tf.OPTForCausalLM),
    }


FAMILIES = list(_configs())
MODEL_TYPES = ("gpt2", "gpt_neox", "gptj", "falcon", "starcoder2", "cohere",
               "nemotron", "cohere2", "stablelm", "bloom", "mpt", "opt")


def save_random(path, family, seed=0, config=None, scale=None):
    """A seeded random ``transformers`` model of ``family`` (or of
    ``config``) saved to ``path``, with its norms near 1 and its biases
    redrawn; ``scale`` multiplies every matrix (so that attention and the
    activations leave their near-linear range). Returns (config, the
    torch model)."""
    cfg, cls = _configs()[family]
    cfg = config or cfg
    torch.manual_seed(seed)
    model = cls(cfg).float().eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
            elif "norm" in name or "ln" in name.split(".")[-2]:
                p.copy_(1 + torch.randn(p.shape, generator=gen) * 0.1)
            elif scale is not None and p.dim() == 2:
                p.mul_(scale)
    model.save_pretrained(path, safe_serialization=True)
    return cfg, model


def jax_model(cfg):
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    return jget(cfg.model_type)(JConfig(hf_config=cfg, dtype=jnp.float32))


def torch_model(cfg, device="cpu"):
    from tensorrt_llm_tpu_torch.models import ModelConfig as TConfig
    from tensorrt_llm_tpu_torch.models import get_model_class as tget
    return tget(cfg.model_type)(TConfig(hf_config=cfg, dtype=torch.float32,
                                        device=device))


def _correct(jm, monkeypatch):
    """The JAX model with its two faults corrected: the rotary style its
    RopeConfig names, and the exact GELU for "gelu"."""
    from tensorrt_llm_tpu.models import gpt_family as jgf
    for attr in ("attn_spec", "sliding_spec"):
        spec = getattr(jm, attr, None)
        if spec is not None and spec.rope is not None:
            setattr(jm, attr, dataclasses.replace(
                spec, is_neox=spec.rope.is_neox))
    monkeypatch.setitem(jgf._ACTS, "gelu",
                        lambda x: jax.nn.gelu(x, approximate=False))


def load_both(path, cfg):
    """(JAX model, its params, port model, {load route: port params})."""
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file

    from tensorrt_llm_tpu_torch.models import from_jax_params
    st = str(path / "model.safetensors")
    jm = jax_model(cfg)
    sd = dict(np_load(st))
    if "lm_head.weight" not in sd and cfg.model_type == "falcon":
        # the JAX Falcon loader reads the tied head by its own name
        # (test_jax_falcon_cannot_load_a_tied_checkpoint)
        sd["lm_head.weight"] = sd["transformer.word_embeddings.weight"]
    jparams = jm.load_hf_state_dict(sd)
    tm = torch_model(cfg)
    return jm, jparams, tm, {
        "from_jax_params": from_jax_params(jax.tree.map(np.asarray,
                                                        jparams)),
        "safetensors": tm.load_hf_state_dict(load_file(st))}


@pytest.fixture(scope="module", params=FAMILIES)
def family(request, tmp_path_factory):
    path = tmp_path_factory.mktemp(request.param)
    cfg, _ = save_random(path, request.param)
    return load_both(path, cfg)


@pytest.mark.parametrize("load", ["from_jax_params", "safetensors"])
def test_prefill_then_decode_match_jax(family, load, monkeypatch):
    jm, jparams, tm, tparams = family
    _correct(jm, monkeypatch)
    want, got = prefill_then_decode(jm, jparams, tm, tparams[load])
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0.05
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_knobs_are_set_as_the_jax_models_set_them(family):
    jm, _, tm, _ = family
    for knob in ("parallel_block", "shared_ln", "act_name", "gated_mlp",
                 "logit_scale", "pos_offset", "ln_eps"):
        if hasattr(jm, knob):          # the JAX GPT-2 is a class of its own
            assert getattr(tm, knob) == getattr(jm, knob), knob
    for knob in ("num_heads", "num_kv_heads", "head_dim", "sm_scale",
                 "alibi_slopes", "sliding_window"):
        assert getattr(tm.attn_spec, knob) == pytest.approx(
            getattr(jm.attn_spec, knob)), knob
    assert (tm.attn_spec.rope is None) == (jm.attn_spec.rope is None)
    if tm.attn_spec.rope is not None:
        for knob in ("rope_theta", "partial_rotary_factor", "is_neox"):
            assert getattr(tm.attn_spec.rope, knob) == \
                getattr(jm.attn_spec.rope, knob), knob


def test_every_model_type_is_registered():
    """The port resolves the thirteen model types to the classes the JAX
    package names."""
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu_torch.models import get_model_class as tget
    for t in MODEL_TYPES + ("gpt_oss",):
        assert tget(t).__name__ == jget(t).__name__, t
        assert set(jget(t).architectures) <= set(tget(t).architectures), t


def test_cohere2_layer_specs():
    """Cohere2: window and rope on the sliding layers (three of four),
    neither on the global one; the engine's split keys see both."""
    tm = torch_model(_configs()["cohere2"][0])
    specs = tm.layer_specs
    assert [s.sliding_window for s in specs] == [8, 8, 8, None]
    assert [s.rope is not None for s in specs] == [True] * 3 + [False]
    assert tm.attention_windows() == (8, None)
    st = torch_model(_configs()["starcoder2"][0])
    assert st.attention_windows() == (16,)


@pytest.mark.parametrize("family", ["bloom", "mpt"])
def test_alibi_slopes_match_transformers(family):
    """The port's ALiBi slopes are those ``transformers`` builds, also for
    a head count that is not a power of two."""
    from transformers.models.bloom.modeling_bloom import build_alibi_tensor
    from tensorrt_llm_tpu_torch.models.modeling_utils import alibi_slopes
    for n in (4, 6, 32, 71):
        # [n, 1, positions]: slope x position
        want = build_alibi_tensor(torch.ones(1, 2), n, torch.float32)
        np.testing.assert_allclose(np.asarray(alibi_slopes(n)),
                                   want[:, 0, 1].numpy(), rtol=1e-6)
    tm = torch_model(_configs()[family][0])
    assert len(tm.attn_spec.alibi_slopes) == tm.num_heads


@pytest.mark.parametrize("family", ["bloom", "mpt"])
def test_alibi_slopes_reach_attention_only_as_a_device_tensor(family):
    """The model holds its spec's slopes as one float32 tensor, and
    ``attention_block`` refuses a spec with slopes but no tensor (or a
    tensor without slopes) rather than copying a tuple at every call."""
    from tensorrt_llm_tpu_torch.models.modeling_utils import attention_block
    tm = torch_model(_configs()[family][0])
    assert tm.alibi_t.dtype == torch.float32
    np.testing.assert_array_equal(tm.alibi_t.numpy(),
                                  np.float32(tm.attn_spec.alibi_slopes))
    plain = dataclasses.replace(tm.attn_spec, alibi_slopes=None)
    for spec, slopes in ((tm.attn_spec, None), (plain, tm.alibi_t)):
        with pytest.raises(ValueError, match="device tensor"):
            attention_block({}, torch.zeros(1, tm.hidden_size), None, None,
                            spec, None, alibi_slopes=slopes)


@pytest.mark.parametrize("bias", [False, True])
def test_layer_norm_residual_matches_jax(bias):
    """The port's residual add + LayerNorm (the sequential block's second
    norm) gives the JAX package's normed rows and new residual."""
    from tensorrt_llm_tpu.ops.norm import layer_norm_residual as jax_lnr
    from tensorrt_llm_tpu_torch.ops.norm import layer_norm_residual
    rng = np.random.default_rng(3)
    x, r = (rng.standard_normal((5, 48)).astype(np.float32)
            for _ in range(2))
    w = (1 + 0.3 * rng.standard_normal(48)).astype(np.float32)
    b = (0.2 * rng.standard_normal(48)).astype(np.float32) if bias else None
    want = jax_lnr(jnp.asarray(x), jnp.asarray(r), jnp.asarray(w),
                   None if b is None else jnp.asarray(b), 1e-5)
    got = layer_norm_residual(torch.from_numpy(x), torch.from_numpy(r),
                              torch.from_numpy(w),
                              None if b is None else torch.from_numpy(b),
                              1e-5)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5)


@pytest.mark.parametrize("case", ["gptj", "cohere", "gpt_neox", "falcon_bias"])
def test_reference_faults_show_against_transformers(tmp_path, case):
    """Each reference fault, with the matrices scaled up so that attention
    and the MLP leave their near-linear range: the port's logits agree
    with the ``transformers`` model, the JAX model's do not. gptj and
    cohere: the rotary style; gpt_neox: "gelu" as the tanh approximation;
    falcon_bias: the fused QKV bias that the JAX loader drops."""
    import transformers as tf
    family, cfg = case, None
    if case == "falcon_bias":
        family = "falcon"
        cfg = tf.FalconConfig(vocab_size=V, hidden_size=64,
                              num_hidden_layers=2, num_attention_heads=4,
                              multi_query=True, parallel_attn=True,
                              bias=True, new_decoder_architecture=False,
                              max_position_embeddings=256)
    scale = 1.0 if case == "falcon_bias" else 8.0
    cfg, hf = save_random(tmp_path, family, config=cfg, scale=scale)
    jm, jparams, tm, tparams = load_both(tmp_path, cfg)
    toks = [5, 17, 99, 4, 61, 7, 3, 120, 44, 8, 9, 31, 77]
    with torch.no_grad():
        want = hf(torch.tensor([toks])).logits[0, -1].numpy()
    from tests.test_models import make_prefill_metadata
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    jmd = make_prefill_metadata(jm, len(toks))
    jl, _ = jm.forward(jparams, jnp.asarray(toks, jnp.int32),
                       jm.make_kv_pages(PAGES, PS), jmd)
    tmd = tattn.AttentionMetadata(**{
        f.name: torch.from_numpy(np.array(getattr(jmd, f.name)))
        for f in dataclasses.fields(jmd)
        if f.name in ("kv_lens", "page_indices", "cu_q_lens", "num_seqs",
                      "slot_mapping", "positions", "logits_indices")})
    tl, _ = tm.forward(tparams["safetensors"], torch.tensor(toks),
                       tm.make_kv_pages(PAGES, PS), tmd)
    port_err = np.abs(tl[0].numpy() - want).max()
    jax_err = np.abs(np.asarray(jl)[0] - want).max()
    assert port_err < 1e-5 * np.abs(want).max()
    assert jax_err > 30 * port_err


def test_jax_falcon_cannot_load_a_tied_checkpoint(tmp_path):
    """Reference fault: Falcon ties its head to the embedding by default,
    so a saved checkpoint stores no ``lm_head.weight``, which the JAX
    loader reads unconditionally; the port reads the embedding."""
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file
    cfg, _ = save_random(tmp_path, "falcon")
    st = str(tmp_path / "model.safetensors")
    assert cfg.tie_word_embeddings
    with pytest.raises(KeyError, match="lm_head.weight"):
        jax_model(cfg).load_hf_state_dict(dict(np_load(st)))
    tm = torch_model(cfg)
    params = tm.load_hf_state_dict(load_file(st))
    assert params["lm_head"]["weight"] is params["embed"]


@pytest.mark.parametrize("family,knob,value", [
    ("falcon", "alibi", True),
    ("stablelm", "use_parallel_residual", True),
    ("stablelm", "qk_layernorm", True),
    ("bloom", "apply_residual_connection_post_layernorm", True),
    ("opt", "do_layer_norm_before", False),
    ("opt", "word_embed_proj_dim", 32),
])
def test_configs_the_reference_ignores_are_refused_by_name(family, knob,
                                                           value):
    """Reference fault: the JAX models read none of these knobs and build
    (then serve another function: RoPE for Falcon's ALiBi, a sequential
    block for StableLM's parallel residual, no q/k LayerNorm, the residual
    before BLOOM's norm, OPT-350m's pre-LN without its projections); the
    port refuses each by name."""
    cfg = _configs()[family][0]
    setattr(cfg, knob, value)
    jax_model(cfg)
    with pytest.raises(NotImplementedError, match=knob):
        torch_model(cfg)
