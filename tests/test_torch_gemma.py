"""The port's Gemma 2 and Gemma 3 (text) against the JAX package's, float32,
CPU.

Each model is a tiny random ``transformers`` model (the configs of
tests/test_vswa.py and tests/test_models_batch3.py) at head_dim 16 and
256, saved to a temporary directory with every norm weight (the four per
layer, Gemma 3's per-head q/k norms, the final one) redrawn at std 0.3 so
that the (1 + w) offsets matter. Both packages load the directory; the
port also takes the JAX parameter tree through ``from_jax_params``. A
prefill step of two ragged prompts (11 and 23 tokens, past the 16-token
window), then a decode step: logits and the KV pool agree within 1e-4
(float32 sums in another order). Beside that: ``gemma_rms_norm``
against the JAX one, the bf16 embedding normalizer, the final soft cap,
both ``rope_parameters`` layouts, the layer patterns, Gemma 3 through
both ``LLM``s, and the refusals (speculation on a Gemma target,
``max_attention_window`` on Gemma 3 or a family without VSWA).
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ATOL = 1e-4
PS, PAGES, V = 16, 8, 128


def _config(kind, hd, **kw):
    import transformers as tf
    if kind == "gemma2":
        base = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=4, num_attention_heads=4,
                    num_key_value_heads=2, head_dim=hd,
                    query_pre_attn_scalar=hd, sliding_window=16,
                    max_position_embeddings=256, attn_logit_softcapping=50.0,
                    final_logit_softcapping=30.0)
        base.update(kw)
        return tf.Gemma2Config(**base), tf.Gemma2ForCausalLM
    base = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
                num_hidden_layers=6, num_attention_heads=4,
                num_key_value_heads=2, head_dim=hd, sliding_window=16,
                max_position_embeddings=256,
                rope_scaling={"rope_type": "linear", "factor": 8.0})
    base.update(kw)
    return tf.Gemma3TextConfig(**base), tf.Gemma3ForCausalLM


def save_random(path, kind, hd, seed=0, **kw):
    """A seeded random ``transformers`` Gemma saved to ``path`` with its
    norm weights redrawn; returns (config, the torch model)."""
    cfg, cls = _config(kind, hd, **kw)
    torch.manual_seed(seed)
    model = cls(cfg).float().eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    model.save_pretrained(path, safe_serialization=True)
    return cfg, model


CASES = [("gemma2", 16), ("gemma2", 256), ("gemma3_text", 16),
         ("gemma3_text", 256)]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{k}-hd{h}" for k, h in CASES])
def family(request, tmp_path_factory):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file

    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu_torch.models import ModelConfig as TConfig
    from tensorrt_llm_tpu_torch.models import from_jax_params
    from tensorrt_llm_tpu_torch.models import get_model_class as tget

    kind, hd = request.param
    path = tmp_path_factory.mktemp(f"{kind}{hd}")
    cfg, _ = save_random(path, kind, hd)
    st = path / "model.safetensors"
    jm = jget(cfg.model_type)(JConfig(hf_config=cfg, dtype=jnp.float32))
    jparams = jm.load_hf_state_dict(dict(np_load(str(st))))
    tm = tget(cfg.model_type)(TConfig(hf_config=cfg, dtype=torch.float32,
                                      device="cpu"))
    via_jax = from_jax_params(jax.tree.map(np.asarray, jparams))
    direct = tm.load_hf_state_dict(load_file(str(st)))
    return jm, jparams, tm, {"from_jax_params": via_jax,
                             "safetensors": direct}


def _md(mod, tensor, kv_lens, pages, cu, slots, pos, logits_idx):
    return mod.AttentionMetadata(
        kv_lens=tensor(np.asarray(kv_lens, np.int32)),
        page_indices=tensor(pages), cu_q_lens=tensor(cu),
        num_seqs=tensor(np.asarray([2], np.int32)),
        slot_mapping=tensor(slots), positions=tensor(pos),
        logits_indices=tensor(np.asarray(logits_idx, np.int32)))


@pytest.mark.parametrize("load", ["from_jax_params", "safetensors"])
def test_prefill_then_decode_match_jax(family, load):
    """Prompts of 11 and 23 tokens (pages 0-1 and 2-3), then one decode
    step each: logits at 1e-4, and the KV pool after the prefill."""
    from tensorrt_llm_tpu.ops import attention as jattn
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    jm, jparams, tm, tparams = family
    params = tparams[load]
    rng = np.random.default_rng(0)
    lens = [11, 23]
    pages = np.array([[0, 1] + [0] * (PAGES - 2),
                      [2, 3] + [0] * (PAGES - 2)], np.int32)
    toks = rng.integers(0, V, size=sum(lens)).astype(np.int32)
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
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=ATOL)
    assert np.abs(np.asarray(jl)).max() > 0.05

    nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
    dpos = np.array(lens, np.int32)
    dslots = (pages[[0, 1], dpos // PS] * PS + dpos % PS).astype(np.int32)
    dcu = np.array([0, 1, 2], np.int32)
    kv = [n + 1 for n in lens]
    jl2, _ = jm.forward(jparams, jnp.asarray(nxt), jpool, _md(
        jattn, jnp.asarray, kv, pages, dcu, dslots, dpos, [0, 1]))
    tl2, _ = tm.forward(params, t(nxt).long(), tpool, _md(
        tattn, t, kv, pages, dcu, dslots, dpos, [0, 1]))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL)


def test_layer_parameters(family):
    """Gemma's four norms per layer in place of Llama's two, Gemma 3's
    per-head q/k norms in float32, the lm_head tied to the embedding, and
    the same tensors through both loaders."""
    _, _, tm, tparams = family
    params = tparams["safetensors"]
    layer = params["layers"][0]
    for name in ("input_norm", "post_attn_norm", "pre_ffn_norm",
                 "post_ffn_norm"):
        assert layer[name].shape == (tm.hidden_size,)
    assert "post_norm" not in layer
    gemma3 = tm.hf.model_type == "gemma3_text"
    assert ("q_norm" in layer) == gemma3
    if gemma3:
        assert layer["q_norm"].shape == layer["k_norm"].shape == \
            (tm.head_dim,)
        assert layer["q_norm"].dtype == torch.float32
    assert params["lm_head"]["weight"] is params["embed"]
    via = tparams["from_jax_params"]["layers"][0]
    for name in layer:
        if name in ("qkv", "o", "gate_up", "down"):
            torch.testing.assert_close(via[name]["weight"],
                                       layer[name]["weight"])
        else:
            torch.testing.assert_close(via[name], layer[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma_rms_norm_matches_jax(dtype):
    """(1 + w) in float32, the cast back only at the end: float32 to
    1e-6, bf16 to one bf16 step."""
    from tensorrt_llm_tpu.models.gemma import gemma_rms_norm as jnorm
    from tensorrt_llm_tpu_torch.ops.norm import gemma_rms_norm
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 3, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32) * 0.3
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jnorm(jnp.asarray(x, jd), jnp.asarray(w, jd), 1e-6)
                      .astype(jnp.float32))
    got = gemma_rms_norm(torch.from_numpy(x).to(td),
                         torch.from_numpy(w).to(td), 1e-6)
    assert got.dtype == td
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, 59.75),
                                        (torch.float32, None)])
def test_embedding_normalizer_in_the_model_type(dtype, want):
    """sqrt(hidden) is cast to the model's type before it scales the
    embeddings (the JAX model's ``jnp.asarray(sqrt(H), dtype)``): at
    Gemma-2-9B's hidden 3584, bf16 rounds 59.866 to 59.75 (its step there
    is 0.25)."""
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    cfg, _ = _config("gemma2", 256, hidden_size=3584)
    tm = get_model_class("gemma2")(ModelConfig(hf_config=cfg, dtype=dtype,
                                               device="cpu"))
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jax_scale = float(jnp.asarray(math.sqrt(3584), jd))
    assert tm.embed_scale == jax_scale
    if want is not None:
        assert tm.embed_scale == want
    else:
        assert tm.embed_scale == pytest.approx(math.sqrt(3584), rel=1e-7)


def test_final_soft_cap(tmp_path):
    """Gemma 2's logits are 30 tanh(raw / 30): against the same model with
    the cap off, and bounded by 30 at logits blown up past it."""
    from safetensors.torch import load_file

    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    cfg, _ = save_random(tmp_path, "gemma2", 16, seed=4)
    tm = get_model_class("gemma2")(ModelConfig(
        hf_config=cfg, dtype=torch.float32, device="cpu"))
    params = tm.load_hf_state_dict(load_file(
        str(tmp_path / "model.safetensors")))
    params["final_norm"] = params["final_norm"] + 200.0   # raw logits > 30
    toks = np.arange(3, 20, dtype=np.int32)
    pages = np.arange(PAGES, dtype=np.int32)[None]
    n = len(toks)
    i32 = dict(dtype=torch.int32)
    md = tattn.AttentionMetadata(
        kv_lens=torch.tensor([n], **i32), page_indices=torch.from_numpy(pages),
        cu_q_lens=torch.tensor([0, n], **i32),
        num_seqs=torch.tensor([1], **i32), slot_mapping=torch.arange(n, **i32),
        positions=torch.arange(n, **i32),
        logits_indices=torch.tensor([n - 1], **i32))
    capped, _ = tm.forward(params, torch.from_numpy(toks).long(),
                           tm.make_kv_pages(PAGES, PS), md)
    tm.final_softcap = None
    raw, _ = tm.forward(params, torch.from_numpy(toks).long(),
                        tm.make_kv_pages(PAGES, PS), md)
    assert raw.abs().max() > 30
    assert capped.abs().max() < 30
    torch.testing.assert_close(capped, 30.0 * torch.tanh(raw / 30.0),
                               rtol=1e-6, atol=1e-6)


def test_rope_parameters_both_layouts():
    """Gemma 3's two rotary tables read alike from transformers 4's
    attributes (rope_theta, rope_scaling, rope_local_base_freq) and from
    transformers 5's ``rope_parameters`` keyed by layer type, and agree
    with the JAX model's."""
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    cfg, _ = _config("gemma3_text", 16, rope_theta=1e6,
                     rope_local_base_freq=1e4)
    tf5 = types.SimpleNamespace(**{
        k: v for k, v in cfg.to_dict().items()
        if k not in ("rope_theta", "rope_scaling", "rope_local_base_freq")})
    tf5.rope_parameters = {
        "full_attention": {"rope_type": "linear", "factor": 8.0,
                           "rope_theta": 1e6},
        "sliding_attention": {"rope_type": "default", "rope_theta": 1e4}}
    models = [get_model_class("gemma3_text")(ModelConfig(
        hf_config=c, dtype=torch.float32, device="cpu")) for c in (cfg, tf5)]
    jm = jget("gemma3_text")(JConfig(hf_config=cfg, dtype=jnp.float32))
    for tm in models:
        g, loc = tm.attn_spec.rope, tm.local_rope
        assert (g.rope_theta, g.scaling_type, g.scaling_factor) == \
            (1e6, "linear", 8.0)
        assert (loc.rope_theta, loc.scaling_type) == (1e4, "none")
        jg, jl = jm.attn_spec.rope, jm.local_rope
        assert (g.rope_theta, g.scaling_type, g.scaling_factor) == \
            (jg.rope_theta, jg.scaling_type, jg.scaling_factor)
        assert (loc.rope_theta, loc.scaling_type) == \
            (jl.rope_theta, jl.scaling_type)


@pytest.mark.parametrize("kind,layers,layer_types", [
    ("gemma2", 4, None),                    # even layers slide
    ("gemma3_text", 12, None),              # five local to one global
    ("gemma3_text", 4, ["full_attention", "sliding_attention",
                        "sliding_attention", "full_attention"]),
])
def test_layer_patterns_match_jax(kind, layers, layer_types):
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    cfg, _ = _config(kind, 16, num_hidden_layers=layers)
    if layer_types is None:
        cfg.layer_types = None
    else:
        cfg.layer_types = layer_types
    tm = get_model_class(kind)(ModelConfig(hf_config=cfg,
                                           dtype=torch.float32,
                                           device="cpu"))
    jm = jget(kind)(JConfig(hf_config=cfg, dtype=jnp.float32))
    want = [jm._layer_is_sliding(i) for i in range(layers)]
    got = [s.sliding_window is not None for s in tm.layer_specs]
    assert got == want
    if layer_types is None:
        rule = (lambda i: i % 2 == 0) if kind == "gemma2" else \
            (lambda i: (i + 1) % 6 != 0)
        assert got == [rule(i) for i in range(layers)]
    assert set(tm.attention_windows()) == {None, 16}


def _llm_kwargs(**kw):
    return dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
                max_input_len=64, max_seq_len=128, max_num_tokens=256, **kw)


def test_gemma3_llm_matches_jax_llm(tmp_path):
    """Gemma 3 at hd 16 through both ``LLM``s, greedy, two prompts past
    the 16-token window: identical tokens."""
    from tensorrt_llm_tpu import LLM as JLLM
    from tensorrt_llm_tpu import KvCacheConfig as JKv
    from tensorrt_llm_tpu import SamplingParams as JSp
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    save_random(tmp_path, "gemma3_text", 16, seed=2)
    prompts = [list(range(2, 40)), list(range(5, 25))]
    out = {}
    for name, cls, kv, sp, extra in (
            ("jax", JLLM, JKv, JSp, dict(model=str(tmp_path))),
            ("torch", LLM, KvCacheConfig, SamplingParams,
             dict(model=str(tmp_path), device="cpu"))):
        llm = cls(kv_cache_config=kv(tokens_per_block=8, max_tokens=2048),
                  **_llm_kwargs(), **extra)
        try:
            res = llm.generate(prompts, sp(max_tokens=12, top_k=1,
                                           end_id=-1))
        finally:
            llm.shutdown()
        out[name] = [r.outputs[0].token_ids for r in res]
    assert out["torch"] == out["jax"]
    assert [len(t) for t in out["torch"]] == [12, 12]


@pytest.mark.parametrize("model_type", ["gemma2", "gemma3_text"])
def test_speculation_refused_on_gemma_target(model_type):
    from tensorrt_llm_tpu_torch.llmapi.llm_args import (SpeculativeConfig,
                                                        check_ported_spec)
    sc = SpeculativeConfig(mode="EAGLE3", max_draft_len=3)
    with pytest.raises(NotImplementedError, match=model_type):
        check_ported_spec(sc, model_type)


def test_max_attention_window_refused_on_gemma3_and_llama(tmp_path):
    """Gemma 3's five-to-one layers fail the strict alternation check
    (the JAX package's ValueError); a family without VSWA refuses the
    setting by name."""
    from transformers import LlamaConfig

    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig
    cfg, _ = _config("gemma3_text", 16)
    kv = KvCacheConfig(tokens_per_block=8, max_tokens=1024,
                       max_attention_window=[16, 128])
    with pytest.raises(ValueError, match="alternation"):
        LLM(cfg, device="cpu", kv_cache_config=kv, **_llm_kwargs())
    llama = LlamaConfig(vocab_size=V, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4)
    with pytest.raises(NotImplementedError, match="max_attention_window"):
        LLM(llama, device="cpu", kv_cache_config=kv, **_llm_kwargs())
    with pytest.raises(ValueError):
        KvCacheConfig(max_attention_window=[0])
