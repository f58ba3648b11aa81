"""The port's DeepSeek-V3 / DeepSeek-V2 (MLA over a paged latent cache,
MoE with shared experts) against the JAX package's, float32, CPU.

Tiny seeded ``transformers`` models (the configs of tests/test_deepseek.py
and tests/test_models_batch4.py::test_deepseek_v2, vocab 128), their norms
and V3's correction bias redrawn so that they matter: V3 with
``q_lora_rank``, V2 greedy without it (DeepSeek-V2-Lite's shape) and V2
group-limited. Logits of a prefill step (prompts of 11 and 23 tokens) and
the decode step after it agree with the JAX model's within 1e-4 (float32
sums in another order), from the checkpoint and through
``from_jax_params``; the absorbed decode path agrees with the
decompressed one within 2e-4 (the JAX test's tolerance); greedy tokens
through both ``LLM``s are identical with K-step windows (absorbed) and
rider windows (decompressed).

Two faults of the JAX model are reproduced against ``transformers``:
it ignores ``rope_scaling`` (yarn frequencies, and DeepSeek-V3's
softmax scale times mscale^2), and it allocates the latent pool in the
model's type under an 8-bit ``kv_cache_dtype``.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dense_families import PAGES, PS, prefill_then_decode

ATOL = 1e-4
V = 128


def _cfg(kind, **over):
    import transformers as tf
    base = dict(vocab_size=V, hidden_size=64, intermediate_size=128,
                moe_intermediate_size=48, num_hidden_layers=3,
                num_attention_heads=4, num_key_value_heads=4,
                n_routed_experts=4, num_experts_per_tok=2,
                n_shared_experts=1, q_lora_rank=32, kv_lora_rank=16,
                qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
                first_k_dense_replace=1, norm_topk_prob=True,
                routed_scaling_factor=1.0, max_position_embeddings=256)
    if kind == "v3":
        base.update(n_group=1, topk_group=1)
        return tf.DeepseekV3Config(**dict(base, **over)), \
            tf.DeepseekV3ForCausalLM
    if kind == "v2_greedy":
        base.update(topk_method="greedy", n_group=1, topk_group=1,
                    q_lora_rank=None)
    else:
        base.update(topk_method="group_limited_greedy", n_group=2,
                    topk_group=1, routed_scaling_factor=1.5)
    return tf.DeepseekV2Config(**dict(base, **over)), \
        tf.DeepseekV2ForCausalLM


KINDS = ["v3", "v2_greedy", "v2_group"]


def random_model(cfg, cls, seed=0):
    """A seeded ``transformers`` model with its norms near 1 and the
    router's correction bias (V3) drawn, in float32."""
    torch.manual_seed(seed)
    model = cls(cfg).float().eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.copy_(1 + torch.randn(p.shape, generator=gen) * 0.1)
        for name, b in model.named_buffers():
            if name.endswith("e_score_correction_bias"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
    return model


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


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    from tensorrt_llm_tpu_torch.models import from_jax_params
    cfg, cls = _cfg(request.param)
    hf = random_model(cfg, cls)
    jm, jparams, tm, tparams = _models(cfg, _sd(hf))
    return jm, jparams, tm, {
        "safetensors": tparams,
        "from_jax_params": from_jax_params(jax.tree.map(np.asarray,
                                                        jparams))}, hf


@pytest.mark.parametrize("load", ["safetensors", "from_jax_params"])
def test_logits_match_jax(pair, load):
    """A prefill step of two ragged prompts, then a decode step (T == S:
    the absorbed path) give the JAX model's logits."""
    jm, jparams, tm, tparams, _ = pair
    want, got = prefill_then_decode(jm, jparams, tm, tparams[load])
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0.05
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_layer_parameters(pair):
    """One dense layer then MoE layers; ``uk`` / ``uv`` split from the
    unquantized kv_b; the router bias in float32; the pool one latent row
    of kv_lora_rank + qk_rope_head_dim a token and layer."""
    _, _, tm, tparams, hf = pair
    layers = tparams["safetensors"]["layers"]
    assert "gate_up" in layers[0] and "router" not in layers[0]
    assert all("router" in lay for lay in layers[1:])
    assert layers[1]["router_bias"].dtype == torch.float32
    assert layers[1]["uk"].shape == (4, 16, 16)
    assert layers[1]["uv"].shape == (4, 16, 16)
    assert ("q_a" in layers[0]) == bool(hf.config.q_lora_rank)
    assert tm.kv_pool_shape(5, PS) == (3, 5, PS, 24)
    assert tm.make_kv_pages(5, PS).dtype == torch.float32
    assert tm.attention_windows() == ()
    assert set(tparams["from_jax_params"]["layers"][1]) == set(layers[1])


def _decode_md(tattn, kv_lens, pages, pos, slots):
    t = torch.from_numpy
    n = len(kv_lens)
    return tattn.AttentionMetadata(
        kv_lens=t(np.asarray(kv_lens, np.int32)), page_indices=t(pages),
        cu_q_lens=t(np.arange(n + 1, dtype=np.int32)),
        num_seqs=t(np.asarray([n], np.int32)),
        slot_mapping=t(np.asarray(slots, np.int32)),
        positions=t(np.asarray(pos, np.int32)),
        logits_indices=t(np.arange(n, dtype=np.int32)))


def _prefill(tm, params, pool, tokens, start=0, pages=None, max_kv=None):
    """One sequence's tokens at positions start.. as one prefill step
    (page table of one row, or ``pages``)."""
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    t = torch.from_numpy
    T = len(tokens)
    pages = np.arange(PAGES, dtype=np.int32)[None] if pages is None \
        else pages
    pos = np.arange(start, start + T, dtype=np.int32)
    md = tattn.AttentionMetadata(
        kv_lens=t(np.asarray([start + T], np.int32)),
        page_indices=t(pages),
        cu_q_lens=t(np.asarray([0, T], np.int32)),
        num_seqs=t(np.asarray([1], np.int32)),
        slot_mapping=t(pages[0, pos // PS] * PS + pos % PS),
        positions=t(pos),
        logits_indices=t(np.asarray([T - 1], np.int32)), max_kv_len=max_kv)
    return tm.forward(params, t(np.asarray(tokens)).long(), pool, md)


def test_absorbed_matches_decompressed(pair):
    """The same decode step on the absorbed path (latent space, W_UK and
    W_UV) and with uk / uv stripped (kv_b over the gathered latents), and
    the path counters each step adds to."""
    from tensorrt_llm_tpu_torch.models import deepseek
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    _, _, tm, tparams, _ = pair
    params = tparams["safetensors"]
    toks = np.random.default_rng(1).integers(0, V, 20)
    pool = tm.make_kv_pages(PAGES, PS)
    _prefill(tm, params, pool, toks[:19])
    pages = np.arange(PAGES, dtype=np.int32)[None]
    md = _decode_md(tattn, [20], pages, [19], [19])
    a0, d0 = deepseek.MLA_ABSORBED, deepseek.MLA_DECOMPRESSED
    la, _ = tm.forward(params, torch.tensor([int(toks[19])]), pool.clone(),
                       md)
    assert (deepseek.MLA_ABSORBED - a0, deepseek.MLA_DECOMPRESSED - d0) \
        == (3, 0)
    stripped = dict(params, layers=[
        {k: v for k, v in lay.items() if k not in ("uk", "uv")}
        for lay in params["layers"]])
    lb, _ = tm.forward(stripped, torch.tensor([int(toks[19])]),
                       pool.clone(), md)
    assert deepseek.MLA_DECOMPRESSED - d0 == 3
    np.testing.assert_allclose(la.numpy(), lb.numpy(), atol=2e-4, rtol=2e-4)


def test_decompressed_chunks_match_one_chunk(pair, monkeypatch):
    """The decompressed path over chunks of positions (a budget of 32
    positions' keys and values: 4 chunks) and of query tiles (one tile of
    32 tokens a chunk: 5 chunks), merged by its online softmax, gives the
    logits and the latents of one chunk within 1e-5: 100 prompt tokens
    after a prefix of 20, in one step."""
    from tensorrt_llm_tpu_torch.models import deepseek
    _, _, tm, tparams, _ = pair
    params = tparams["safetensors"]
    toks = np.random.default_rng(4).integers(0, V, 120)
    outs = []
    for small in (False, True):
        if small:
            width = tm.num_heads * (tm.qk_nope + tm.v_dim)
            monkeypatch.setattr(deepseek, "MLA_CHUNK_BYTES", width * 6 * 32)
            monkeypatch.setattr(deepseek, "MLA_TILE", 32)
        pool = tm.make_kv_pages(PAGES, PS)
        _prefill(tm, params, pool, toks[:20])
        logits, _ = _prefill(tm, params, pool, toks[20:], start=20)
        outs.append((logits.numpy(), pool[:, :, :, :].numpy()))
    np.testing.assert_allclose(outs[1][0], outs[0][0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(outs[1][1], outs[0][1], atol=1e-5, rtol=0)


def test_prompt_step_shaped_like_a_decode_step_matches_jax(pair):
    """Two prompt tokens of one sequence beside an empty row (T == S == 2):
    the JAX model takes the absorbed path, each token against its own
    sequence's latents; so does the port."""
    from tests.test_models import make_prefill_metadata
    from tensorrt_llm_tpu_torch.models import deepseek
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    jm, jparams, tm, tparams, _ = pair
    toks = np.asarray([7, 101], np.int32)
    jmd = make_prefill_metadata(jm, 2)
    jl, _ = jm.forward(jparams, jnp.asarray(toks), jm.make_kv_pages(16, 16),
                       jmd)
    md = tattn.AttentionMetadata(**{
        f: torch.from_numpy(np.array(getattr(jmd, f)))
        for f in ("kv_lens", "page_indices", "cu_q_lens", "num_seqs",
                  "slot_mapping", "positions", "logits_indices")})
    a0 = deepseek.MLA_ABSORBED
    tl, _ = tm.forward(tparams["safetensors"], torch.from_numpy(toks).long(),
                       tm.make_kv_pages(16, 16), md)
    assert deepseek.MLA_ABSORBED - a0 == 3
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], atol=ATOL,
                               rtol=0)


def test_decode_matches_prefill_and_transformers(pair):
    """A prefix prefilled, then one decode step at a time (absorbed),
    gives the last logits of one prefill over the whole prompt and of the
    ``transformers`` model; a step whose gather is bounded by its
    max_kv_len gives the unbounded step's logits."""
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    _, _, tm, tparams, hf = pair
    params = tparams["safetensors"]
    toks = np.random.default_rng(2).integers(0, V, 21)
    full, _ = _prefill(tm, params, tm.make_kv_pages(PAGES, PS), toks)
    bounded, _ = _prefill(tm, params, tm.make_kv_pages(PAGES, PS), toks,
                          max_kv=21)
    pool = tm.make_kv_pages(PAGES, PS)
    _prefill(tm, params, pool, toks[:17])
    pages = np.arange(PAGES, dtype=np.int32)[None]
    for p in range(17, 21):
        out, _ = tm.forward(params, torch.tensor([int(toks[p])]), pool,
                            _decode_md(tattn, [p + 1], pages, [p], [p]))
    with torch.no_grad():
        ref = hf(torch.tensor([toks.tolist()])).logits[0, -1].numpy()
    np.testing.assert_allclose(out[0].numpy(), full[0].numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(bounded.numpy(), full.numpy(), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(full[0].numpy(), ref, atol=ATOL, rtol=0)


def test_latent_write_drops_padding_slots(pair):
    """Padding tokens of a bucket carry out-of-range slots: their latents
    are dropped and only the real tokens' rows of each layer change."""
    _, _, tm, tparams, _ = pair
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    t = torch.from_numpy
    params = tparams["safetensors"]
    T, n = 8, 5
    pages = np.asarray([[3] + [0] * (PAGES - 1)], np.int32)
    slots = np.full(T, PAGES * PS, np.int32)
    slots[:n] = 3 * PS + np.arange(n)
    md = tattn.AttentionMetadata(
        kv_lens=t(np.asarray([n], np.int32)), page_indices=t(pages),
        cu_q_lens=t(np.asarray([0, n], np.int32)),
        num_seqs=t(np.asarray([1], np.int32)), slot_mapping=t(slots),
        positions=t(np.arange(T, dtype=np.int32)),
        logits_indices=t(np.asarray([n - 1], np.int32)))
    pool = tm.make_kv_pages(PAGES, PS)
    tm.forward(params, torch.arange(T), pool, md)
    written = pool.abs().sum(-1) != 0                  # [L, P, ps]
    want = torch.zeros_like(written)
    want[:, 3, :n] = True
    assert torch.equal(written, want)


def test_group_limit_masks_dropped_groups_with_zero():
    """Dropped groups are set to 0.0, not -inf, as transformers does:
    with negative biased scores, a top k can land in a dropped group (the
    JAX ``_group_limit``)."""
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu_torch.ops.moe import group_limit
    choice = np.asarray([[-0.5, -0.4, 0.3, 0.9, -0.1, -0.2, -0.3, -0.6],
                         [0.2, 0.1, -0.9, -0.8, 0.5, 0.4, 0.3, 0.0]],
                        np.float32)
    cfg, _ = _cfg("v3", n_group=4, topk_group=1, n_routed_experts=8)
    jm = jget("deepseek_v3")(JConfig(hf_config=cfg, dtype=jnp.float32))
    for fn, score in ((lambda g: jnp.sum(jax.lax.top_k(g, 2)[0], axis=-1),
                       "top2"), (lambda g: jnp.max(g, axis=-1), "max")):
        want = np.asarray(jm._group_limit(jnp.asarray(choice), fn))
        got = group_limit(torch.from_numpy(choice), 4, 1, score).numpy()
        np.testing.assert_array_equal(got, want)
    got = group_limit(torch.from_numpy(choice), 4, 1, "top2")
    assert (got[0] == 0).tolist() == [True, True, False, False] + \
        [True] * 4
    assert torch.topk(got[1], 3)[1].tolist()[:2] == [4, 5]


def test_routers_match_transformers():
    """The V3 router (sigmoid, correction bias, group limit by top-2
    sums, renormalised, scaled) and the V2 gate (softmax, group limit by
    maxima, scaled) choose and weigh as transformers' modules do."""
    import transformers as tf
    from tensorrt_llm_tpu_torch.ops.moe import (sigmoid_bias_routing,
                                                softmax_group_routing)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(16, 64, generator=gen)
    cfg = tf.DeepseekV3Config(hidden_size=64, n_routed_experts=8,
                              num_experts_per_tok=3, n_group=4, topk_group=2,
                              norm_topk_prob=True, routed_scaling_factor=2.5)
    router = tf.models.deepseek_v3.modeling_deepseek_v3.DeepseekV3TopkRouter(
        cfg)
    with torch.no_grad():
        router.weight.copy_(torch.randn(8, 64, generator=gen))
        router.e_score_correction_bias.copy_(torch.randn(8, generator=gen)
                                             * 0.1)
        idx, w = router(x[None])
    pw, pidx = sigmoid_bias_routing(x @ router.weight.t(),
                                    router.e_score_correction_bias, 3, True,
                                    2.5, 4, 2)
    order = torch.argsort(idx, dim=-1)
    assert torch.equal(torch.sort(pidx.long(), -1)[0],
                       torch.gather(idx, 1, order))
    torch.testing.assert_close(torch.sort(pw, -1)[0],
                               torch.sort(w, -1)[0])
    cfg2 = tf.DeepseekV2Config(hidden_size=64, n_routed_experts=8,
                               num_experts_per_tok=3, n_group=4,
                               topk_group=2, topk_method="group_limited_greedy",
                               routed_scaling_factor=2.5)
    gate = tf.models.deepseek_v2.modeling_deepseek_v2.DeepseekV2MoEGate(cfg2)
    with torch.no_grad():
        gate.weight.copy_(torch.randn(8, 64, generator=gen))
        idx, w = gate(x[None])
    pw, pidx = softmax_group_routing(x @ gate.weight.t(), 3, 2.5, 4, 2)
    assert torch.equal(torch.sort(pidx.long(), -1)[0],
                       torch.sort(idx, -1)[0])
    torch.testing.assert_close(torch.sort(pw, -1)[0], torch.sort(w, -1)[0])


# --------------------------------------------------------------------- #
# Reference faults (ROADMAP C)
# --------------------------------------------------------------------- #
YARN = {"type": "yarn", "factor": 40.0,
        "original_max_position_embeddings": 64, "beta_fast": 32,
        "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707}


@pytest.mark.parametrize("kind,mscale_all_dim", [("v3", 0.707),
                                                 ("v2_greedy", 0.0)])
def test_rope_scaling_is_served_as_transformers_serves_it(kind,
                                                          mscale_all_dim):
    """Fault 1: with yarn ``rope_scaling`` (every published DeepSeek
    config) the port gives transformers' logits: yarn frequencies, and
    for V3 the softmax scale times mscale(40, 0.707)^2; the JAX model,
    which builds its rope without scaling, does not."""
    cfg, cls = _cfg(kind, rope_scaling=dict(YARN,
                                            mscale_all_dim=mscale_all_dim))
    hf = random_model(cfg, cls, seed=4)
    jm, jparams, tm, tparams = _models(cfg, _sd(hf))
    toks = np.random.default_rng(4).integers(0, V, 30)
    with torch.no_grad():
        ref = hf(torch.tensor([toks.tolist()])).logits[0, -1].numpy()
    got, _ = _prefill(tm, tparams, tm.make_kv_pages(PAGES, PS), toks)
    err = np.abs(got[0].numpy() - ref).max()
    assert err < ATOL
    from tests.test_models import make_prefill_metadata
    jl, _ = jm.forward(jparams, jnp.asarray(toks, jnp.int32),
                       jm.make_kv_pages(PAGES, PS),
                       make_prefill_metadata(jm, len(toks)))
    assert np.abs(np.asarray(jl)[0] - ref).max() > max(100 * err, 5 * ATOL)
    m = 0.1 * 0.707 * np.log(40.0) + 1
    want = (1 / np.sqrt(24)) * (m * m if mscale_all_dim else 1.0)
    assert tm.sm_scale == pytest.approx(want)


def test_v2_greedy_gate_ignores_groups_as_transformers_does():
    """DeepSeek-V2 with ``topk_method`` "greedy" and 2 groups: transformers'
    gate takes the top k over every expert, as the port does; the JAX
    model limits the groups whenever ``n_group`` > 1."""
    cfg, cls = _cfg("v2_greedy", n_group=2, topk_group=1)
    hf = random_model(cfg, cls, seed=6)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if name.endswith("mlp.gate.weight"):
                p.mul_(25.0)               # decisive choices
    jm, jparams, tm, tparams = _models(cfg, _sd(hf))
    toks = np.random.default_rng(6).integers(0, V, 30)
    with torch.no_grad():
        ref = hf(torch.tensor([toks.tolist()])).logits[0, -1].numpy()
    got, _ = _prefill(tm, tparams, tm.make_kv_pages(PAGES, PS), toks)
    err = np.abs(got[0].numpy() - ref).max()
    assert err < ATOL
    from tests.test_models import make_prefill_metadata
    jl, _ = jm.forward(jparams, jnp.asarray(toks, jnp.int32),
                       jm.make_kv_pages(PAGES, PS),
                       make_prefill_metadata(jm, len(toks)))
    assert np.abs(np.asarray(jl)[0] - ref).max() > max(100 * err, 5 * ATOL)


def test_weight_quantized_mla_matches_jax(monkeypatch):
    """Under W8A16 quantized at load, both models split uk / uv from the
    checkpoint's float kv_b, so decode stays absorbed (in the model's
    type) while prefill decompresses through the quantized kv_b: logits
    of the prefill and decode steps agree with the JAX model's (its
    Pallas kernels in interpret mode) within 1e-4."""
    from tensorrt_llm_tpu.llmapi.llm_args import QuantConfig as JQ
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu.quantization.mode import QuantAlgo as JA
    from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
    from tensorrt_llm_tpu_torch.models import ModelConfig, deepseek
    from tensorrt_llm_tpu_torch.models import get_model_class
    from tensorrt_llm_tpu_torch.quantization.mode import QuantAlgo
    monkeypatch.setenv("TLLM_TPU_PALLAS_INTERPRET", "1")
    cfg, cls = _cfg("v3")
    sd = _sd(random_model(cfg, cls, seed=7))
    jm = jget("deepseek_v3")(JConfig(hf_config=cfg, dtype=jnp.float32,
                                     quant_config=JQ(quant_algo=JA.W8A16)))
    tm = get_model_class("deepseek_v3")(ModelConfig(
        hf_config=cfg, dtype=torch.float32, device="cpu",
        quant_config=QuantConfig(quant_algo=QuantAlgo.W8A16)))
    jparams = jm.load_hf_state_dict(dict(sd))
    tparams = tm.load_hf_state_dict({k: torch.from_numpy(v)
                                     for k, v in sd.items()})
    assert "weight_scale" in tparams["layers"][1]["kv_b"]
    assert "uk" in tparams["layers"][1]
    a0 = deepseek.MLA_ABSORBED
    want, got = prefill_then_decode(jm, jparams, tm, tparams)
    assert deepseek.MLA_ABSORBED - a0 == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_prefix_reuse_serves_the_same_tokens():
    """A prompt that extends a served one reuses its latent blocks (the
    pool is paged like any KV pool) and gets the tokens of an engine
    without reuse."""
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SamplingParams
    cfg, cls = _cfg("v2_greedy")
    hf = random_model(cfg, cls, seed=8)
    rng = np.random.default_rng(8)
    base = rng.integers(1, V - 1, 48).tolist()
    ext = base + rng.integers(1, V - 1, 9).tolist()
    sp = SamplingParams(max_tokens=10, top_k=1, ignore_eos=True)
    outs = []
    for reuse in (True, False):
        llm = LLM(hf, device="cpu", dtype="float32", skip_tokenizer_init=True,
                  max_batch_size=4, max_input_len=64, max_seq_len=96,
                  kv_cache_config=KvCacheConfig(
                      tokens_per_block=PS, max_tokens=1024,
                      enable_block_reuse=reuse))
        try:
            first = llm.generate(base, sp).outputs[0].token_ids
            second = llm.generate(ext, sp).outputs[0].token_ids
            reused = llm.kv_cache_manager.get_stats().reused_blocks
        finally:
            llm.shutdown()
        outs.append((first, second, reused))
    assert outs[0][2] >= 3 and outs[1][2] == 0
    assert outs[0][:2] == outs[1][:2]


@pytest.mark.parametrize("algo", ["INT8", "FP8"])
def test_8bit_kv_cache_is_refused_by_name(algo):
    """Fault 2: the JAX model allocates the latent pool in the model's
    type under an 8-bit ``kv_cache_dtype`` (which its engine sizes at one
    byte an element); the port refuses the 8-bit cache by name."""
    from tensorrt_llm_tpu.llmapi.llm_args import QuantConfig as JQ
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu.quantization.mode import KvCacheQuantAlgo as JK
    from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    from tensorrt_llm_tpu_torch.quantization.mode import KvCacheQuantAlgo
    cfg, _ = _cfg("v3")
    jm = jget("deepseek_v3")(JConfig(
        hf_config=cfg, dtype=jnp.bfloat16,
        quant_config=JQ(kv_cache_quant_algo=getattr(JK, algo))))
    assert jm.config.kv_cache_dtype != jnp.bfloat16
    assert jm.make_kv_pages(2, PS).dtype == jnp.bfloat16
    mc = ModelConfig(hf_config=cfg, dtype=torch.bfloat16, device="cpu",
                     quant_config=QuantConfig(
                         kv_cache_quant_algo=getattr(KvCacheQuantAlgo, algo)))
    with pytest.raises(NotImplementedError,
                       match=str(mc.kv_cache_dtype).replace(".", r"\.")):
        get_model_class("deepseek_v3")(mc)


# --------------------------------------------------------------------- #
# Engine and LLM
# --------------------------------------------------------------------- #
def test_engine_sizes_the_latent_pool():
    """The engine takes a page's bytes from the model's own pool shape
    (the latent rows, 24 floats here, not 2 * heads * head_dim), asks no
    K1 split of a model without K1 layers but keys its graphs by the KV
    bound, which sizes MLA's gather, and counts MLA's per-position
    scratch in the graph pool's estimate."""
    from tensorrt_llm_tpu_torch import KvCacheConfig, LLM
    cfg, cls = _cfg("v2_greedy")
    llm = LLM(cfg, device="cpu", dtype="float32", skip_tokenizer_init=True,
              max_batch_size=4, max_input_len=32, max_seq_len=64,
              max_num_tokens=64, kv_cache_config=KvCacheConfig(
                  tokens_per_block=PS, max_tokens=256))
    try:
        e = llm.engine
        assert e.bytes_per_kv_block == 3 * PS * 24 * 4
        assert tuple(e.kv_pages.shape) == (3, e.num_kv_pages, PS, 24)
        assert e._splits(4, 64) == ("kv_bound", 64)
        assert e._step_key(4, 64, True, False, 0) != \
            e._step_key(4, 128, True, False, 0)
        assert e._window_key(4, 4, 32, 64, True, False) != \
            e._window_key(4, 4, 32, 128, True, False)
        scratch = llm.model.attn_scratch_bytes(4, 4, e.max_seq_len)
        assert scratch > 0
        assert e.graph_pool_estimate() > 2 * scratch
    finally:
        llm.shutdown()


def test_mla_scratch_grows_with_the_latents_alone():
    """At DeepSeek-V2-Lite's widths (``serving_profile``'s published
    config), 64 rows and a 512-token rider chunk over 8 sequences, the
    graph pool's MLA scratch grows with the positions by the latents and
    the tiles' mask alone (the decompressed keys and values are chunked):
    under 5 GB at 16,384 positions, where every sequence's float32 keys
    and values would take 19 GB."""
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    from tensorrt_llm_tpu_torch.models import deepseek
    from tensorrt_llm_tpu_torch.tools.serving_profile import \
        deepseek_v2_lite_config
    cfg = deepseek_v2_lite_config(layers=2)
    tm = get_model_class(cfg.model_type)(ModelConfig(
        hf_config=cfg, dtype=torch.bfloat16, device="cpu"))
    seqs, tokens = 64 + 9, 64 + 512
    at = [tm.attn_scratch_bytes(seqs, tokens, n) for n in (4096, 16384)]
    per_position = (at[1] - at[0]) / (16384 - 4096)
    assert per_position <= seqs * 6 * 576 + seqs * 16 * 16 + \
        tokens + seqs * deepseek.MLA_TILE
    assert at[1] < 5e9
    assert seqs * 16384 * 16 * (128 + 128) * 4 > 19e9


@pytest.mark.parametrize("mode", ["EAGLE3", "MTP"])
def test_speculation_refused_by_name(mode):
    """EAGLE3 on a DeepSeek target (the head is a Llama layer over the
    target's hidden rows, which the JAX package does not draft for) and
    MTP on LongCat-Flash (its forward collects no hidden rows, nor does
    the JAX one) are refused by name; MTP on DeepSeek targets is served
    (tests/test_torch_mtp.py)."""
    from tensorrt_llm_tpu_torch import LLM, SpeculativeConfig
    if mode == "EAGLE3":
        cfg, _ = _cfg("v3")
    else:
        from tests.test_torch_longcat import _cfg as longcat_cfg
        cfg = longcat_cfg()
    with pytest.raises(NotImplementedError, match=mode):
        LLM(cfg, device="cpu", dtype="float32", skip_tokenizer_init=True,
            speculative_config=SpeculativeConfig(mode=mode, max_draft_len=2))


def _staggered(llm, pkg, prompts, n_out, logprobs=False):
    """The first two prompts decode 3 * ``n_out`` tokens; the rest arrive
    once the first has a token, so that they ride the K-step windows as
    rider chunks. Returns each request's tokens (with ``logprobs``, also
    the chosen tokens' log-probabilities, which every step records)."""
    if pkg == "jax":
        from tensorrt_llm_tpu import SamplingParams
    else:
        from tensorrt_llm_tpu_torch import SamplingParams
    sp = SamplingParams(max_tokens=n_out, top_k=1, ignore_eos=True)
    long = SamplingParams(max_tokens=3 * n_out, top_k=1, ignore_eos=True)
    futs = [llm.generate_async(p, long) for p in prompts[:2]]
    deadline = time.monotonic() + 120
    while not futs[0]._result.request.output_token_ids \
            and time.monotonic() < deadline:
        time.sleep(0.005)
    futs += [llm.generate_async(p, sp) for p in prompts[2:]]
    outs = [f.result(300).outputs[0] for f in futs]
    if logprobs:
        return [o.token_ids for o in outs], \
            [[v for d in o.logprobs for v in d.values()] for o in outs]
    return [o.token_ids for o in outs]


def test_llm_greedy_matches_jax_with_windows_and_riders():
    """Greedy tokens of the port's ``LLM`` equal the JAX ``LLM``'s on a
    tiny DeepSeek-V3 served with K = 4 windows (absorbed MLA) and rider
    chunks inside them (decompressed MLA)."""
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.models import deepseek
    cfg, cls = _cfg("v3")
    hf = random_model(cfg, cls, seed=5)
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=8,
              max_input_len=64, max_seq_len=128, max_num_tokens=128,
              decode_multi_step=4, mixed_window_ctx=32)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, V - 1, size=n).tolist()
               for n in (30, 41, 23, 47, 19)]
    tllm = T.LLM(hf, device="cpu", kv_cache_config=T.KvCacheConfig(
        tokens_per_block=PS, max_tokens=2048), **kw)
    try:
        a0, d0 = deepseek.MLA_ABSORBED, deepseek.MLA_DECOMPRESSED
        got = _staggered(tllm, "torch", prompts, 16)
        riders = tllm.engine.mixed_windows_dispatched
        absorbed = deepseek.MLA_ABSORBED - a0
        decompressed = deepseek.MLA_DECOMPRESSED - d0
    finally:
        tllm.shutdown()
    jllm = J.LLM(model=hf, kv_cache_config=J.KvCacheConfig(
        tokens_per_block=PS, max_tokens=2048), **kw)
    try:
        want = _staggered(jllm, "jax", prompts, 16)
    finally:
        jllm.shutdown()
    assert riders > 0 and absorbed > 0 and decompressed > 0
    assert [len(t) for t in got] == [48] * 2 + [16] * 3
    assert got == want


def test_llm_rider_longer_than_the_decode_bound_matches_jax():
    """A rider window keys MLA's gather by a bound that covers its riders
    too: decode rows of a few tokens (a KV bound of 32) beside prompts of
    100 and 90 tokens riding in 32-token chunks give the JAX ``LLM``'s
    greedy tokens and their log-probabilities within 1e-4 (a gather sized
    by the decode rows alone truncated the riders' context and moved the
    100-token rider's first log-probability by 4.5e-3)."""
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    cfg, cls = _cfg("v2_greedy")
    hf = random_model(cfg, cls, seed=9)
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=8,
              max_input_len=128, max_seq_len=192, max_num_tokens=128,
              decode_multi_step=4, mixed_window_ctx=32)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, V - 1, size=n).tolist()
               for n in (5, 7, 100, 90)]
    tllm = T.LLM(hf, device="cpu", kv_cache_config=T.KvCacheConfig(
        tokens_per_block=PS, max_tokens=2048), **kw)
    try:
        got, got_lp = _staggered(tllm, "torch", prompts, 8, logprobs=True)
        riders = tllm.engine.mixed_windows_dispatched
    finally:
        tllm.shutdown()
    jllm = J.LLM(model=hf, kv_cache_config=J.KvCacheConfig(
        tokens_per_block=PS, max_tokens=2048), **kw)
    try:
        want, want_lp = _staggered(jllm, "jax", prompts, 8, logprobs=True)
    finally:
        jllm.shutdown()
    assert riders > 0
    assert [len(t) for t in got] == [24] * 2 + [8] * 2
    assert got == want
    for a, b in zip(got_lp, want_lp):
        np.testing.assert_allclose(a, b, atol=ATOL)
