"""The port's Qwen2, Qwen3, Mixtral, Qwen2-MoE, Qwen3-MoE and OLMoE
against the JAX package's, float32, CPU.

Each family is a tiny random ``transformers`` model (the configs of
tests/test_models_extra.py and tests/test_models_batch3.py) saved to a
temporary directory; norms, biases and the routers are redrawn so that
they matter (routers at std 0.5, so that no top-k choice is a near-tie).
Both packages load the directory; the port also takes the JAX parameter
tree through ``from_jax_params``. A prefill step of two ragged prompts,
then a decode step: logits and the KV pool agree within 1e-4 (float32
sums in another order). Qwen2-MoE keeps transformers' zero attention
biases in that comparison, because the JAX loader drops them; the port
carries them, which ``test_qwen2_moe_carries_attention_biases`` holds
against transformers itself.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ATOL = 1e-4
PS, PAGES, V = 16, 8, 128


def _configs():
    import transformers as tf
    base = dict(vocab_size=V, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2,
                max_position_embeddings=256, tie_word_embeddings=False)
    return {
        "qwen2": (tf.Qwen2Config(intermediate_size=128, **base),
                  tf.Qwen2ForCausalLM),
        "qwen3": (tf.Qwen3Config(intermediate_size=128, head_dim=16,
                                 **base), tf.Qwen3ForCausalLM),
        "mixtral": (tf.MixtralConfig(intermediate_size=128,
                                     num_local_experts=4,
                                     num_experts_per_tok=2, **base),
                    tf.MixtralForCausalLM),
        "qwen2_moe": (tf.Qwen2MoeConfig(
            intermediate_size=128, moe_intermediate_size=48,
            shared_expert_intermediate_size=96, num_experts=4,
            num_experts_per_tok=2, norm_topk_prob=False,
            decoder_sparse_step=1, mlp_only_layers=[], **base),
            tf.Qwen2MoeForCausalLM),
        "qwen3_moe": (tf.Qwen3MoeConfig(
            intermediate_size=128, moe_intermediate_size=48, head_dim=16,
            num_experts=4, num_experts_per_tok=2, norm_topk_prob=True,
            **base), tf.Qwen3MoeForCausalLM),
        "olmoe": (tf.OlmoeConfig(pad_token_id=0, eos_token_id=1,
                                 bos_token_id=2, intermediate_size=96,
                                 num_experts=4, num_experts_per_tok=2,
                                 norm_topk_prob=False, **base),
                  tf.OlmoeForCausalLM),
    }


FAMILIES = ["qwen2", "qwen3", "mixtral", "qwen2_moe", "qwen3_moe", "olmoe"]


def save_random(path, family, seed=0, biases=None):
    """A seeded random ``transformers`` model of ``family`` saved to
    ``path``; returns (config, the torch model). ``biases`` (default: all
    but Qwen2-MoE) redraws the attention biases."""
    cfg, cls = _configs()[family]
    torch.manual_seed(seed)
    model = cls(cfg).float().eval()
    if biases is None:
        biases = family != "qwen2_moe"
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias") and biases:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
            elif "norm" in name:
                p.copy_(1 + torch.randn(p.shape, generator=gen) * 0.1)
            elif name.endswith("gate.weight") and "proj" not in name \
                    and "shared_expert_gate" not in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
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


def test_layer_parameters_of_each_family(family):
    """What each family's layer holds: q/k norms of the right widths, the
    biases of Qwen2, the experts in ops/moe.py's layout, the shared
    expert of Qwen2-MoE."""
    _, _, tm, tparams = family
    layer = tparams["safetensors"]["layers"][0]
    mt = tm.hf.model_type
    H, hd = tm.hidden_size, tm.head_dim
    assert ("q_norm" in layer) == (mt in ("qwen3", "qwen3_moe", "olmoe"))
    if mt == "olmoe":
        assert layer["q_norm"].shape == (tm.num_heads * hd,)
        assert layer["k_norm"].shape == (tm.num_kv_heads * hd,)
    elif "q_norm" in layer:
        assert layer["q_norm"].shape == layer["k_norm"].shape == (hd,)
    assert ("bias" in layer["qkv"]) == (mt in ("qwen2", "qwen2_moe"))
    moe = mt in ("mixtral", "qwen2_moe", "qwen3_moe", "olmoe")
    assert ("gate_up" in layer) != moe
    if moe:
        E, I = tm.num_experts, tm.moe_intermediate
        assert layer["router"].shape == (E, H)
        assert layer["w_gate_up"].shape == (E, H, 2 * I)
        assert layer["w_down"].shape == (E, I, H)
        via = tparams["from_jax_params"]["layers"][0]
        for k in ("router", "w_gate_up", "w_down"):
            assert torch.equal(via[k], layer[k])
    assert ("se_gate_up" in layer) == (mt == "qwen2_moe")


def test_qwen2_moe_carries_attention_biases(tmp_path):
    """Qwen2-MoE's q/k/v biases (nonzero here) reach the logits: the
    port's last-token logits equal transformers' own forward within
    1e-4. (The JAX loader drops these biases: ROADMAP C.)"""
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    from safetensors.torch import load_file
    cfg, hf = save_random(tmp_path, "qwen2_moe", seed=5, biases=True)
    assert hf.model.layers[0].self_attn.q_proj.bias.abs().max() > 0.01
    tm = get_model_class("qwen2_moe")(ModelConfig(
        hf_config=cfg, dtype=torch.float32, device="cpu"))
    params = tm.load_hf_state_dict(load_file(
        str(tmp_path / "model.safetensors")))
    toks = list(range(3, 20))
    n = len(toks)
    pages = np.zeros((1, PAGES), np.int32)
    pages[0, :2] = [0, 1]
    pos = np.arange(n, dtype=np.int32)
    t = torch.from_numpy
    md = tattn.AttentionMetadata(
        kv_lens=t(np.array([n], np.int32)), page_indices=t(pages),
        cu_q_lens=t(np.array([0, n], np.int32)),
        num_seqs=t(np.array([1], np.int32)), slot_mapping=t(pos.copy()),
        positions=t(pos), logits_indices=t(np.array([n - 1], np.int32)))
    logits, _ = tm.forward(params, torch.tensor(toks),
                           tm.make_kv_pages(PAGES, PS), md)
    with torch.no_grad():
        ref = hf(torch.tensor([toks])).logits[0, -1]
    np.testing.assert_allclose(logits[0].numpy(), ref.numpy(), atol=ATOL)


def test_sliding_window_follows_use_sliding_window():
    """A Qwen config's window counts only when ``use_sliding_window``
    says so (a plain config may carry both fields)."""
    from transformers import PretrainedConfig
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    kw = dict(model_type="qwen3", vocab_size=V, hidden_size=64,
              intermediate_size=128, num_hidden_layers=1,
              num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              sliding_window=32)
    for use, want in ((False, None), (True, 32)):
        m = get_model_class("qwen3")(ModelConfig(
            hf_config=PretrainedConfig(use_sliding_window=use, **kw),
            dtype=torch.float32, device="cpu"))
        assert m.attn_spec.sliding_window == want


def test_rope_theta_from_rope_parameters():
    """transformers 5 keeps theta in ``rope_parameters`` (no
    ``rope_theta`` attribute): the port reads it there."""
    from types import SimpleNamespace
    from tensorrt_llm_tpu_torch.ops.rope import RopeConfig, compute_inv_freq
    new = SimpleNamespace(hidden_size=64, num_attention_heads=4,
                          head_dim=16, max_position_embeddings=256,
                          rope_parameters={"rope_type": "default",
                                           "rope_theta": 1e6})
    old = SimpleNamespace(hidden_size=64, num_attention_heads=4,
                          head_dim=16, max_position_embeddings=256,
                          rope_theta=1e6, rope_scaling=None)
    a, b = RopeConfig.from_hf_config(new), RopeConfig.from_hf_config(old)
    assert a.rope_theta == b.rope_theta == 1e6
    assert a.scaling_type == b.scaling_type == "none"
    assert torch.equal(compute_inv_freq(a), compute_inv_freq(b))
    assert math.isclose(float(compute_inv_freq(a)[1]), 1e6 ** (-2 / 16),
                        rel_tol=1e-6)         # a float32 table


@pytest.mark.parametrize("family_name", FAMILIES)
def test_dummy_weights_serve(family_name):
    """A bare config serves seeded random weights (load_format="dummy")
    through ``LLM.generate`` on the CPU, every family."""
    import tensorrt_llm_tpu_torch as T
    cfg, _ = _configs()[family_name]
    llm = T.LLM(cfg, device="cpu", dtype="float32", skip_tokenizer_init=True,
                max_batch_size=4, max_input_len=32, max_seq_len=64,
                max_num_tokens=64,
                kv_cache_config=T.KvCacheConfig(tokens_per_block=16,
                                                max_tokens=512))
    try:
        outs = llm.generate([[5, 6, 7], list(range(10, 30))],
                            T.SamplingParams(max_tokens=6, top_k=1,
                                             ignore_eos=True))
    finally:
        llm.shutdown()
    assert [len(o.outputs[0].token_ids) for o in outs] == [6, 6]
    assert all(0 <= t < V for o in outs for t in o.outputs[0].token_ids)
