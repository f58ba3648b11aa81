"""The port's LongCat-Flash (the shortcut-connected MoE over paired MLA
sublayers) against the JAX package's, float32, CPU.

A tiny seeded ``transformers`` model (the config of
tests/test_models_batch4.py::test_longcat_flash, vocab 128: two pairs,
4 routed experts of 32 and 2 zero experts, top 2), its norms and router
correction bias redrawn and its router weights scaled up so that they
matter (rows pick zero experts). A prefill step of two
ragged prompts then a decode step give the JAX model's logits within
1e-4, from the checkpoint and through ``from_jax_params``, and the last
prefill logits give transformers'; the shortcut MoE gives the JAX
``_sc_moe``'s output on rows that pick zero experts (which the port
leaves out of the experts' products); greedy tokens of both ``LLM``s are
equal, with K-step windows, with chunked prefill and with rider chunks.

The JAX LongCat-Flash forward takes no ``collect_hidden`` (its MTP
drafter fails on it with a TypeError, shown below); the port refuses MTP
on this target by name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_deepseek import _prefill, _sd, _staggered, random_model
from tests.test_torch_dense_families import PAGES, PS, prefill_then_decode

ATOL = 1e-4
V = 128


def _cfg(**over):
    from transformers import LongcatFlashConfig
    base = dict(vocab_size=V, hidden_size=64, num_attention_heads=4,
                n_routed_experts=4, moe_topk=2, expert_ffn_hidden_size=32,
                ffn_hidden_size=128, q_lora_rank=32, kv_lora_rank=16,
                qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16,
                num_layers=2, zero_expert_num=2, head_dim=8,
                max_position_embeddings=256)
    return LongcatFlashConfig(**dict(base, **over))


def _hf(seed=0, **over):
    """The seeded model with its router weights scaled up (std 0.5), so
    that rows choose their experts by their scores, zero experts
    included, and not all by the correction bias."""
    from transformers import LongcatFlashForCausalLM
    hf = random_model(_cfg(**over), LongcatFlashForCausalLM, seed)
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "router.classifier" in name:
                p.mul_(25.0)
    return hf


@pytest.fixture(scope="module")
def pair():
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu_torch.models import ModelConfig as TConfig
    from tensorrt_llm_tpu_torch.models import from_jax_params
    from tensorrt_llm_tpu_torch.models import get_model_class as tget
    hf = _hf()
    sd = _sd(hf)
    cfg = hf.config
    tm = tget(cfg.model_type)(TConfig(hf_config=cfg, dtype=torch.float32,
                                      device="cpu"))
    jm = jget(cfg.model_type)(JConfig(hf_config=cfg, dtype=jnp.float32))
    jparams = jm.load_hf_state_dict(dict(sd))
    return jm, jparams, tm, {
        "safetensors": tm.load_hf_state_dict(
            {k: torch.from_numpy(v) for k, v in sd.items()}),
        "from_jax_params": from_jax_params(jax.tree.map(np.asarray,
                                                        jparams))}, hf


@pytest.mark.parametrize("load", ["safetensors", "from_jax_params"])
def test_logits_match_jax(pair, load):
    """Prefill of two ragged prompts (decompressed MLA), then a decode
    step (absorbed MLA)."""
    jm, jparams, tm, tparams, _ = pair
    want, got = prefill_then_decode(jm, jparams, tm, tparams[load])
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0.05
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_logits_match_transformers(pair):
    _, _, tm, tparams, hf = pair
    toks = np.random.default_rng(3).integers(0, V, 19)
    got, _ = _prefill(tm, tparams["safetensors"],
                      tm.make_kv_pages(PAGES, PS), toks)
    with torch.no_grad():
        ref = hf(torch.tensor([toks.tolist()])).logits[0, -1].numpy()
    np.testing.assert_allclose(got[0].numpy(), ref, atol=ATOL, rtol=0)


def test_layer_parameters(pair):
    """Two pairs: four flat MLA + dense sublayers (the latent pool's four
    layers), the lora scales folded into q_b and kv_b, and per pair the
    router over routed and zero experts, its float32 correction bias and
    the stacked experts."""
    _, _, tm, tparams, hf = pair
    params = tparams["safetensors"]
    layers, pairs = params["layers"], params["pairs"]
    assert len(layers) == 4 and len(pairs) == 2
    assert all("gate_up" in lay and "router" not in lay for lay in layers)
    assert pairs[1]["router"].shape == (6, 64)
    assert pairs[1]["router_bias"].dtype == torch.float32
    assert pairs[1]["w_gate_up"].shape == (4, 64, 64)
    assert pairs[1]["w_down"].shape == (4, 32, 64)
    assert tm.kv_pool_shape(5, PS) == (4, 5, PS, 24)
    raw = hf.model.layers[1].self_attn[1].q_b_proj.weight.detach()
    torch.testing.assert_close(layers[3]["q_b"]["weight"],
                               raw * (64 / 32) ** 0.5)
    raw = hf.model.layers[0].self_attn[0].kv_b_proj.weight.detach()
    torch.testing.assert_close(layers[0]["kv_b"]["weight"],
                               raw * (64 / 16) ** 0.5)
    assert set(tparams["from_jax_params"]["pairs"][0]) == set(pairs[0])


def test_shortcut_moe_matches_jax_on_zero_expert_picks(pair):
    """64 rows through both ``_sc_moe``s: some rows pick a zero expert,
    some pick two; the port's output (zero picks outside the grouped
    products, w * x added) equals the JAX one's (zero picks sent to expert
    0 with weight 0)."""
    jm, jparams, tm, tparams, _ = pair
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    jpair = jax.tree.map(lambda a: a[0], jparams["pairs"])
    want = np.asarray(jm._sc_moe(jpair, jnp.asarray(x)))
    tpair = tparams["safetensors"]["pairs"][0]
    _, idx = tm.sc_route(tpair, torch.from_numpy(x))
    zero = (idx >= 4).sum(-1)
    assert (zero == 1).any() and (zero == 2).any() and (zero == 0).any()
    got = tm.sc_moe(tpair, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("route", ["plain", "dense"])
def test_zero_expert_routes_match_experts_zero_weighted(route,
                                                       monkeypatch):
    """``moe_mlp_zero_experts`` on the CPU's plain route and on the dense
    route (the CUDA float32 one, run here on the CPU) equals the
    experts with zero picks sent to expert 0 at weight 0, plus w * x."""
    from tensorrt_llm_tpu_torch.ops import moe
    gen = torch.Generator().manual_seed(1)
    E, H, I, T, k = 4, 16, 8, 24, 3
    x = torch.randn(T, H, generator=gen)
    wgu = torch.randn(E, H, 2 * I, generator=gen) * 0.3
    wd = torch.randn(E, I, H, generator=gen) * 0.3
    probs = torch.rand(T, k, generator=gen)
    idx = torch.randint(0, E + 3, (T, k), generator=gen).to(torch.int32)
    zero = idx >= E
    want = moe.moe_mlp_plain(x, wgu, wd, torch.where(zero, 0.0, probs),
                             torch.where(zero, 0, idx)) + \
        torch.where(zero, probs, 0.0).sum(-1, keepdim=True) * x
    monkeypatch.setitem(moe._ROUTE_FNS, "plain", moe._ROUTE_FNS[route])
    got = moe.moe_mlp_zero_experts(x, wgu, wd, probs, idx)
    assert zero.any() and (~zero).any()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["windows", "chunked", "riders"])
def test_llm_greedy_matches_jax(mode):
    """Greedy tokens of the port's ``LLM`` equal the JAX ``LLM``'s:
    prompts of 5 and 8 tokens, 8 tokens each, with K = 4 windows; the same
    prompts in chunks of 4 tokens (``max_num_tokens`` 8); and prompts of
    30-47 tokens arriving while two rows decode, riding K-step windows in
    32-token chunks."""
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    hf = _hf(seed=2)
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=8,
              max_input_len=64, max_seq_len=128, max_num_tokens=128,
              decode_multi_step=4)
    ps = PS
    rng = np.random.default_rng(9)
    if mode == "chunked":
        kw["max_num_tokens"], ps = 8, 4
    if mode == "riders":
        kw["mixed_window_ctx"] = 32
        prompts = [rng.integers(1, V - 1, size=n).tolist()
                   for n in (30, 41, 23, 47, 19)]
    else:
        prompts = [rng.integers(1, V - 1, size=n).tolist() for n in (5, 8)]

    def run(pkg, llm):
        if mode == "riders":
            return _staggered(llm, pkg, prompts, 8)
        sp = (J if pkg == "jax" else T).SamplingParams(
            max_tokens=8, top_k=1, ignore_eos=True)
        return [o.outputs[0].token_ids for o in llm.generate(prompts, sp)]

    tllm = T.LLM(hf, device="cpu", kv_cache_config=T.KvCacheConfig(
        tokens_per_block=ps, max_tokens=2048), **kw)
    try:
        got = run("torch", tllm)
        riders = tllm.engine.mixed_windows_dispatched
    finally:
        tllm.shutdown()
    jllm = J.LLM(model=hf, kv_cache_config=J.KvCacheConfig(
        tokens_per_block=ps, max_tokens=2048), **kw)
    try:
        want = run("jax", jllm)
    finally:
        jllm.shutdown()
    assert (riders > 0) == (mode == "riders")
    assert got == want


def test_mtp_on_longcat_refused_by_name():
    from tensorrt_llm_tpu_torch import LLM, SpeculativeConfig
    with pytest.raises(NotImplementedError, match="MTP.*longcat_flash"):
        LLM(_hf(), device="cpu", dtype="float32", skip_tokenizer_init=True,
            speculative_config=SpeculativeConfig(mode="MTP",
                                                 max_draft_len=1))


def test_jax_longcat_forward_takes_no_collect_hidden(pair):
    """The reference fault behind the refusal: the JAX MTP drafter and
    fused window call the target's forward with ``collect_hidden``, which
    the JAX LongCat-Flash forward does not take (every request of the JAX
    ``LLM`` with MTP on this target fails with this TypeError); the
    port's forward refuses it by name."""
    from tests.test_models import make_prefill_metadata
    jm, jparams, tm, tparams, _ = pair
    md = make_prefill_metadata(jm, 4)
    with pytest.raises(TypeError, match="collect_hidden"):
        jm.forward(jparams, jnp.arange(4, dtype=jnp.int32),
                   jm.make_kv_pages(16, 16), md, collect_hidden=True)
    with pytest.raises(NotImplementedError, match="longcat_flash"):
        tm.forward(tparams["safetensors"], torch.arange(4),
                   tm.make_kv_pages(16, 16), None, collect_hidden=True)
