"""The port's GPT-OSS and MXFP4 ingestion against the JAX package's,
float32, CPU.

A tiny seeded ``transformers`` GPT-OSS (the configuration of
tests/test_gpt_oss.py: 4 experts, top 2, window 8) with its norms,
biases and sinks redrawn so that they matter. Both packages load its
state dict, and the port also the JAX parameter tree through
``from_jax_params``: a prefill step of two ragged prompts (11 and 23
tokens, past the window), then a decode step, logits within 1e-4. The
MXFP4 half: ``dequant_mxfp4``, ``quantize_mxfp4`` and
``normalize_mxfp4_state_dict`` give the JAX package's arrays exactly, and a
tiny GPT-OSS loaded from MXFP4 blocks and scales (made with the port's
``quantize_mxfp4``) gives the JAX logits from the same blocks. The MoE
block (ops/moe.py ``moe_mlp_swiglu``) matches the JAX ``_moe`` within
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dense_families import prefill_then_decode

ATOL = 1e-4
VOCAB = 96


def tiny_cfg(**kw):
    from transformers import GptOssConfig
    base = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16, num_local_experts=4,
                num_experts_per_tok=2, sliding_window=8, rope_scaling=None,
                max_position_embeddings=256, pad_token_id=0,
                eos_token_id=1, bos_token_id=2)
    base.update(kw)
    return GptOssConfig(**base)


def random_model(cfg, seed=0):
    """A seeded ``transformers`` GPT-OSS with its norms near 1 and its
    biases and sinks redrawn."""
    from transformers import GptOssForCausalLM
    torch.manual_seed(seed)
    model = GptOssForCausalLM(cfg).float().eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or name.endswith("sinks"):
                p.copy_(torch.randn(p.shape, generator=gen) *
                        (1.0 if name.endswith("sinks") else 0.1))
            elif "norm" in name:
                p.copy_(1 + torch.randn(p.shape, generator=gen) * 0.1)
    return model


def state_dict_np(model):
    return {k: v.detach().float().numpy().copy()
            for k, v in model.state_dict().items()}


def to_mxfp4(sd, num_layers):
    """The experts of ``sd`` as MXFP4 blocks and scales (the release
    layout [E, out, in/32, 16] and [E, out, in/32]), made with the port's
    ``quantize_mxfp4``."""
    from tensorrt_llm_tpu_torch.quantization.mxfp4 import quantize_mxfp4
    out = dict(sd)
    for i in range(num_layers):
        e = f"model.layers.{i}.mlp.experts."
        for nm in ("gate_up_proj", "down_proj"):
            w = np.ascontiguousarray(np.transpose(out.pop(e + nm), (0, 2, 1)))
            out[e + nm + "_blocks"], out[e + nm + "_scales"] = \
                quantize_mxfp4(w)
    return out


def models(cfg):
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu_torch.models import ModelConfig as TConfig
    from tensorrt_llm_tpu_torch.models import get_model_class as tget
    return (jget("gpt_oss")(JConfig(hf_config=cfg, dtype=jnp.float32)),
            tget("gpt_oss")(TConfig(hf_config=cfg, dtype=torch.float32,
                                    device="cpu")))


@pytest.fixture(scope="module")
def pair():
    from tensorrt_llm_tpu_torch.models import from_jax_params
    cfg = tiny_cfg()
    hf = random_model(cfg)
    sd = state_dict_np(hf)
    jm, tm = models(cfg)
    jparams = jm.load_hf_state_dict(sd)
    return jm, jparams, tm, {
        "from_jax_params": from_jax_params(jax.tree.map(np.asarray,
                                                        jparams)),
        "state_dict": tm.load_hf_state_dict(
            {k: torch.from_numpy(v) for k, v in sd.items()})}, hf


@pytest.mark.parametrize("load", ["from_jax_params", "state_dict"])
def test_prefill_then_decode_match_jax(pair, load):
    jm, jparams, tm, tparams, _ = pair
    want, got = prefill_then_decode(jm, jparams, tm, tparams[load],
                                    vocab=VOCAB)
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0.05
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_layer_specs_and_parameters(pair):
    """Even layers slide (window 8), odd ones are global, all with sinks;
    the experts' gate|up columns are de-interleaved as the JAX loader
    does, and the biases and sinks stay float32."""
    jm, jparams, tm, tparams, _ = pair
    specs = tm.layer_specs
    assert [s.sliding_window for s in specs] == [8, None]
    assert all(s.use_sinks for s in specs)
    assert tm.attention_windows() == (8, None)
    layer = tparams["state_dict"]["layers"][0]
    lay = jax.tree.map(np.asarray, jparams["layers"])
    I = tm.moe_intermediate
    np.testing.assert_array_equal(layer["w_gate_up"][..., :I].numpy(),
                                  lay["w_gate"][0])
    np.testing.assert_array_equal(layer["w_gate_up"][..., I:].numpy(),
                                  lay["w_up"][0])
    np.testing.assert_array_equal(layer["b_gate_up"].numpy(),
                                  np.concatenate([lay["b_gate"][0],
                                                  lay["b_up"][0]], -1))
    for name in ("sinks", "router_bias", "b_gate_up", "b_down"):
        assert layer[name].dtype == torch.float32, name


def test_yarn_rope_matches_jax():
    """GPT-OSS's default rope, YaRN (factor 32 over 4,096), at the JAX
    package's tables."""
    from tensorrt_llm_tpu.ops.rope import rope_cos_sin as jcs
    from tensorrt_llm_tpu_torch.ops.rope import rope_cos_sin as tcs
    cfg = tiny_cfg(rope_scaling={
        "rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
        "beta_slow": 1.0, "truncate": False,
        "original_max_position_embeddings": 4096},
        max_position_embeddings=4096 * 32)
    jm, tm = models(cfg)
    assert tm.attn_spec.rope.scaling_type == "yarn"
    pos = np.array([0, 1, 7, 129, 5000, 100000], np.int32)
    for j, t in zip(jcs(jm.attn_spec.rope, jnp.asarray(pos)),
                    tcs(tm.attn_spec.rope, torch.from_numpy(pos))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-6,
                                   atol=2e-6)


def test_moe_block_matches_jax_moe(pair):
    """``moe_mlp_swiglu`` (plain route) against the JAX ``_moe`` on one
    layer's parameters, with inputs large enough that the clamp at 7
    bites."""
    from tensorrt_llm_tpu_torch.ops.moe import moe_mlp_swiglu
    jm, jparams, tm, tparams, _ = pair
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((37, 64)) * 6).astype(np.float32)
    jlayer = jax.tree.map(lambda a: a[0], jparams["layers"])
    want = np.asarray(jm._moe(jlayer, jnp.asarray(x)))
    layer = tparams["state_dict"]["layers"][0]
    got = moe_mlp_swiglu(torch.from_numpy(x), layer["router"],
                         layer["router_bias"], layer["w_gate_up"],
                         layer["b_gate_up"], layer["w_down"],
                         layer["b_down"], tm.top_k, tm.swiglu_limit)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# --------------------------------------------------------------------- #
# MXFP4
# --------------------------------------------------------------------- #
def test_mxfp4_functions_give_the_jax_arrays():
    from tensorrt_llm_tpu.quantization import mxfp4 as J
    from tensorrt_llm_tpu_torch.quantization import mxfp4 as T
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, (3, 5, 4, 16), dtype=np.uint8)
    scales = rng.integers(110, 140, (3, 5, 4), dtype=np.uint8)
    np.testing.assert_array_equal(T.dequant_mxfp4(blocks, scales),
                                  J.dequant_mxfp4(blocks, scales))
    np.testing.assert_array_equal(
        T.dequant_mxfp4(torch.from_numpy(blocks), torch.from_numpy(scales)),
        J.dequant_mxfp4(blocks, scales))
    w = (rng.standard_normal((6, 96)) * 0.05).astype(np.float32)
    w[0, :32] = 0.0                               # an all-zero block
    for got, want in zip(T.quantize_mxfp4(w), J.quantize_mxfp4(w)):
        np.testing.assert_array_equal(got, want)
    sd = {"a.weight": w, "e.gate_up_proj_blocks": blocks,
          "e.gate_up_proj_scales": scales, "lonely_blocks": blocks[0]}
    got, want = T.normalize_mxfp4_state_dict(sd), \
        J.normalize_mxfp4_state_dict(sd)
    assert sorted(got) == sorted(want) == ["a.weight", "e.gate_up_proj",
                                           "lonely_blocks"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_mxfp4_lut_codes():
    """Every e2m1 code at a scale of 2: the hand-built block of
    tests/test_gpt_oss.py."""
    from tensorrt_llm_tpu_torch.quantization.mxfp4 import dequant_mxfp4
    lo = np.arange(16, dtype=np.uint8) & 0xF
    hi = (np.arange(16, dtype=np.uint8)[::-1]) & 0xF
    out = dequant_mxfp4((lo | (hi << 4)).reshape(1, 16),
                        np.array([128], np.uint8))
    lut = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0])
    lut = np.concatenate([lut, -lut])
    np.testing.assert_array_equal(out[0::2], lut[lo] * 2)
    np.testing.assert_array_equal(out[1::2], lut[hi] * 2)


def test_mxfp4_checkpoint_gives_the_jax_logits():
    """A tiny GPT-OSS whose experts are MXFP4 blocks and scales: both
    packages dequantize the same bytes at load, and the logits agree
    within 1e-4 (and differ from the float model's, so the blocks are
    what was served)."""
    cfg = tiny_cfg()
    sd = state_dict_np(random_model(cfg, seed=4))
    sdq = to_mxfp4(sd, cfg.num_hidden_layers)
    jm, tm = models(cfg)
    jparams = jm.load_hf_state_dict(sdq)
    tparams = tm.load_hf_state_dict(
        {k: torch.from_numpy(v) for k, v in sdq.items()})
    want, got = prefill_then_decode(jm, jparams, tm, tparams, vocab=VOCAB)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    _, unq = prefill_then_decode(jm, jm.load_hf_state_dict(sd), tm,
                                 tm.load_hf_state_dict(
                                     {k: torch.from_numpy(v)
                                      for k, v in sd.items()}),
                                 vocab=VOCAB)
    assert np.abs(unq[0] - got[0]).max() > 1e-3
