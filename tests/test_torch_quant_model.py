"""The weight-only quantized Llama of the port against the JAX package's,
on the CPU in float32: model logits on a quantized parameter tree carried
across by ``from_jax_params`` and on the port's own load-time
quantization, ``exclude_modules`` splitting a fused projection, and
greedy tokens through both ``LLM``s.

The JAX side runs with ``TLLM_TPU_PALLAS_INTERPRET=1`` so that its
group-wise methods go through the Pallas dequant-matmul kernel (in
interpret mode) at M <= 128, as they do on a TPU and as the port does on
any device. The seeded config (hidden 256, intermediate 512, group 64)
has widths the kernel takes; the trained parity checkpoint
(tests/assets/tinycode-llama, intermediate 688) does not, so it is used
with W8A16 (no kernel) and, for closeness only, W4A16_AWQ group 16.

Tolerances on logits. Per-channel and zero-point algorithms dequantize
and multiply in float32 on both sides: 1e-4 (sums in another order). On
the kernel route every projection's output is rounded to bf16 on both
sides, and a float32 sum taken in another order rounds to the
neighbouring bf16 value (a relative step of 2**-8 to 2**-7) in about one
element in a hundred of each projection's output; through two layers
these steps, amplified by the final RMSNorm of a small-magnitude hidden
state, add up to a few thousandths on average and to at most 2.3e-2 at
logits of magnitude up to 2.5 (one bf16 step there is 1.6e-2). So the
kernel-route cases hold max |diff| <= 3e-2 and mean |diff| <= 6e-3.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

CKPT = Path(__file__).parent / "assets" / "tinycode-llama"
PS, PAGES = 16, 8
ALGOS = ["W4A16_AWQ", "W8A16", "W4A16_GPTQ", "MXFP4"]
ATOL = {"W4A16_AWQ": 3e-2, "MXFP4": 3e-2, "W8A16": 1e-4, "W4A16_GPTQ": 1e-4}
MEAN_ATOL = 6e-3        # kernel route, see above


def _assert_logits_close(got, want, atol):
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0.05
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
        assert np.abs(g - w).mean() <= min(atol, MEAN_ATOL)


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("TLLM_TPU_PALLAS_INTERPRET", "1")


def _hf_config(**kw):
    from transformers import LlamaConfig
    base = dict(vocab_size=128, hidden_size=256, intermediate_size=512,
                num_hidden_layers=2, num_attention_heads=8,
                num_key_value_heads=4, max_position_embeddings=256,
                tie_word_embeddings=False)
    base.update(kw)
    return LlamaConfig(**base)


def _state_dict(cfg, seed=0):
    """A seeded HF-layout ([out, in]) float32 state dict."""
    rng = np.random.default_rng(seed)
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    hd = H // cfg.num_attention_heads
    nq, nkv = cfg.num_attention_heads * hd, cfg.num_key_value_heads * hd

    def mat(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    sd = {"model.embed_tokens.weight": mat(V, H),
          "model.norm.weight": 1 + mat(H), "lm_head.weight": mat(V, H)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = 1 + mat(H)
        sd[p + "post_attention_layernorm.weight"] = 1 + mat(H)
        for name, shape in [("self_attn.q_proj", (nq, H)),
                            ("self_attn.k_proj", (nkv, H)),
                            ("self_attn.v_proj", (nkv, H)),
                            ("self_attn.o_proj", (H, nq)),
                            ("mlp.gate_proj", (I, H)),
                            ("mlp.up_proj", (I, H)),
                            ("mlp.down_proj", (H, I))]:
            sd[p + name + ".weight"] = mat(*shape)
    return sd


def _models(cfg, algo, group=64, exclude=("lm_head",)):
    from tensorrt_llm_tpu.llmapi.llm_args import QuantConfig as JQ
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu.quantization.mode import QuantAlgo as JAlgo
    from tensorrt_llm_tpu_torch import QuantAlgo, QuantConfig
    from tensorrt_llm_tpu_torch.models import ModelConfig as TConfig
    from tensorrt_llm_tpu_torch.models import get_model_class as tget
    jm = jget("llama")(JConfig(
        hf_config=cfg, dtype=jnp.float32,
        quant_config=JQ(quant_algo=JAlgo[algo], group_size=group,
                        exclude_modules=list(exclude))))
    tm = tget("llama")(TConfig(
        hf_config=cfg, dtype=torch.float32, device="cpu",
        quant_config=QuantConfig(quant_algo=QuantAlgo[algo],
                                 group_size=group,
                                 exclude_modules=list(exclude))))
    return jm, tm


def _md(mod, tensor, kv_lens, pages, cu, slots, pos, logits_idx):
    return mod.AttentionMetadata(
        kv_lens=tensor(np.asarray(kv_lens, np.int32)),
        page_indices=tensor(pages), cu_q_lens=tensor(cu),
        num_seqs=tensor(np.asarray([2], np.int32)),
        slot_mapping=tensor(slots), positions=tensor(pos),
        logits_indices=tensor(np.asarray(logits_idx, np.int32)))


def _prefill_then_decode(jm, jparams, tm, tparams, vocab):
    """Logits of both models on a prefill step of two ragged prompts (34
    rows: the kernel route) and on the decode step that follows."""
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
    jpool = jm.make_kv_pages(PAGES, PS)
    tpool = tm.make_kv_pages(PAGES, PS)
    jl, jpool = jm.forward(jparams, jnp.asarray(toks), jpool, _md(
        jattn, jnp.asarray, lens, pages, cu, slots, pos, [10, 33]))
    tl, tpool = tm.forward(tparams, t(toks).long(), tpool, _md(
        tattn, t, lens, pages, cu, slots, pos, [10, 33]))
    nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
    dpos = np.array(lens, np.int32)
    dslots = (pages[[0, 1], dpos // PS] * PS + dpos % PS).astype(np.int32)
    dcu = np.array([0, 1, 2], np.int32)
    kv = [n + 1 for n in lens]
    jl2, _ = jm.forward(jparams, jnp.asarray(nxt), jpool, _md(
        jattn, jnp.asarray, kv, pages, dcu, dslots, dpos, [0, 1]))
    tl2, _ = tm.forward(tparams, t(nxt).long(), tpool, _md(
        tattn, t, kv, pages, dcu, dslots, dpos, [0, 1]))
    return (np.asarray(jl), np.asarray(jl2)), (tl.numpy(), tl2.numpy())


def _assert_same_tree(got, want, path=""):
    """Integers identical, floats to 1e-6."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{i}]")
    elif want.dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7,
                                   msg=lambda m: f"{path}: {m}")
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), path


@pytest.mark.parametrize("algo", ALGOS)
def test_quantized_logits_match_jax(algo):
    from tensorrt_llm_tpu_torch.models import from_jax_params
    cfg = _hf_config()
    sd = _state_dict(cfg)
    jm, tm = _models(cfg, algo)
    jparams = jm.load_hf_state_dict(sd)
    carried = from_jax_params(jax.tree.map(np.asarray, jparams))
    own = tm.load_hf_state_dict(sd)
    # the port's own load-time quantization gives the carried tree
    _assert_same_tree(own, carried)
    layer = carried["layers"][0]
    assert sorted(layer) == ["down", "gate_up", "input_norm", "o",
                             "post_norm", "qkv"]
    assert layer["qkv"]["weight"].dtype == torch.int8
    assert layer["qkv"]["weight"].shape == (
        128 if algo == "W4A16_AWQ" else 256, 512)
    assert ("weight_zero" in layer["qkv"]) == (algo == "W4A16_GPTQ")
    assert carried["lm_head"]["weight"].dtype == torch.float32  # excluded
    want, got = _prefill_then_decode(jm, jparams, tm, carried, cfg.vocab_size)
    _assert_logits_close(got, want, ATOL[algo])


def test_excluding_k_proj_keeps_q_k_v_apart():
    """``m_q`` and ``m_kv`` go by name: with k_proj excluded, q stays
    quantized, k and v stay float, and nothing is fused across them."""
    from tensorrt_llm_tpu_torch.models import from_jax_params
    cfg = _hf_config()
    sd = _state_dict(cfg, seed=1)
    jm, tm = _models(cfg, "W4A16_AWQ", exclude=("lm_head", "k_proj"))
    jparams = jm.load_hf_state_dict(sd)
    carried = from_jax_params(jax.tree.map(np.asarray, jparams))
    own = tm.load_hf_state_dict(sd)
    _assert_same_tree(own, carried)
    layer = own["layers"][1]
    assert "qkv" not in layer
    assert layer["q"]["weight"].dtype == torch.int8
    assert layer["q"]["weight"].shape == (128, 256)        # packed [K/2, N]
    assert layer["k"]["weight"].dtype == torch.float32
    assert layer["k"]["weight"].shape == (128, 256)        # [out, in]
    assert layer["v"]["weight"].shape == (128, 256)

    # The JAX forward hands m_q to all three projections
    # (models/llama.py:293), so it cannot run this tree as it is. The
    # reference applies each projection by what its parameters hold.
    quantized, plain = jm.m_q, jm.m_kv
    assert type(quantized).__name__ == "WeightOnlyGroupwiseMethod"
    assert type(plain).__name__ == "LinearMethod"

    class ByParams:
        def apply(self, params, x):
            m = quantized if "weight_scale" in params else plain
            return m.apply(params, x)
    jm.m_q = ByParams()
    want, got = _prefill_then_decode(jm, jparams, tm, own, cfg.vocab_size)
    _assert_logits_close(got, want, 3e-2)


def test_quantized_lm_head_and_per_channel_int4():
    """W4A16 with nothing excluded: lm_head goes through its own method;
    the JAX tree's int4 arrays arrive as int8 in [-8, 7]."""
    from tensorrt_llm_tpu_torch.models import from_jax_params
    cfg = _hf_config()
    sd = _state_dict(cfg, seed=2)
    jm, tm = _models(cfg, "W4A16", exclude=())
    jparams = jm.load_hf_state_dict(sd)
    assert jparams["lm_head"]["weight"].dtype == jnp.int4
    carried = from_jax_params(jax.tree.map(np.asarray, jparams))
    own = tm.load_hf_state_dict(sd)
    _assert_same_tree(own, carried)
    w = own["lm_head"]["weight"]
    assert w.dtype == torch.int8 and w.shape == (256, 128)
    assert int(w.min()) >= -8 and int(w.max()) <= 7
    want, got = _prefill_then_decode(jm, jparams, tm, own, cfg.vocab_size)
    _assert_logits_close(got, want, 1e-4)


def test_tied_embeddings_share_or_quantize():
    cfg = _hf_config(tie_word_embeddings=True, num_hidden_layers=1)
    _, tm = _models(cfg, "W8A16")
    p = tm.init_params(seed=0)
    assert p["lm_head"]["weight"] is p["embed"]
    _, tm = _models(cfg, "W8A16", exclude=())
    p = tm.init_params(seed=0)
    assert p["lm_head"]["weight"].dtype == torch.int8
    assert p["lm_head"]["weight"].shape == (256, 128)
    assert p["embed"].dtype == torch.float32


def test_awq_group16_on_trained_checkpoint_is_close():
    """The trained checkpoint's down_proj (K = 688) is outside the
    kernel's int4 contract, so the port dequantizes it while its other
    projections take the kernel's arithmetic; the JAX side here takes the
    float32 dot everywhere (its kernel would assert on K = 688). Logits
    stay within 5e-2 of each other at magnitudes of about 10: bf16
    rounding of the activations through six layers."""
    from safetensors.torch import load_file
    from transformers import AutoConfig
    from tensorrt_llm_tpu.quantization.lazy_state_dict import LazyStateDict
    cfg = AutoConfig.from_pretrained(CKPT)
    jm, tm = _models(cfg, "W4A16_AWQ", group=16)
    for m in (jm.m_q, jm.m_kv, jm.m_o, jm.m_mlp):
        m.use_pallas = False
    jparams = jm.load_hf_state_dict(LazyStateDict(CKPT))
    own = tm.load_hf_state_dict(load_file(str(CKPT / "model.safetensors")))
    want, got = _prefill_then_decode(jm, jparams, tm, own, 256)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=5e-2, rtol=0)
        assert (g.argmax(-1) == w.argmax(-1)).all()


# --------------------------------------------------------------------- #
# LLM
# --------------------------------------------------------------------- #
PROMPTS = [list(b"def forward(self, x):\n    return "),
           list(b"import numpy as np\n"), [7, 3, 99, 4, 61]]


def _llm_kwargs():
    return dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
                max_input_len=64, max_seq_len=128, max_num_tokens=128)


def _greedy_both(path, algo=None, group=64, n=16, logprobs=None):
    """Greedy tokens of the same prompts through both packages' LLM (and
    the JAX side's top-2 logprobs per token under "jax_logprobs")."""
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    out = {}
    for name, pkg, extra in (("jax", J, dict(model=str(path))),
                             ("torch", T, dict(model=str(path),
                                               device="cpu"))):
        kw = _llm_kwargs()
        if algo is not None:
            kw["quant_config"] = pkg.QuantConfig(
                quant_algo=pkg.QuantAlgo[algo], group_size=group)
        llm = pkg.LLM(kv_cache_config=pkg.KvCacheConfig(
            tokens_per_block=16, max_tokens=1024), **extra, **kw)
        try:
            res = llm.generate(PROMPTS, pkg.SamplingParams(
                max_tokens=n, top_k=1, logprobs=logprobs))
            out[name] = [r.outputs[0].token_ids for r in res]
            out[name + "_logprobs"] = [r.outputs[0].logprobs for r in res]
            out[name + "_llm_algo"] = llm.args.quant_config.quant_algo.value
        finally:
            llm.shutdown()
    return out


def _save_checkpoint(path, cfg, sd, quantization_config=None):
    from safetensors.numpy import save_file
    path.mkdir(parents=True, exist_ok=True)
    cfg.save_pretrained(path)
    if quantization_config is not None:
        c = json.loads((path / "config.json").read_text())
        c["quantization_config"] = quantization_config
        (path / "config.json").write_text(json.dumps(c))
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              str(path / "model.safetensors"))


def test_llm_w8a16_greedy_matches_jax_on_trained_checkpoint():
    out = _greedy_both(CKPT, "W8A16")
    assert out["torch"] == out["jax"]
    assert [len(t) for t in out["torch"]] == [16] * 3


def test_llm_w4a16_awq_greedy_matches_jax_on_seeded_config(tmp_path):
    """Kernel route end to end. Greedy tokens are identical wherever the
    reference decides by more than the logit tolerance of this route
    (3e-2, module docstring): a random-weight model has near-ties, and a
    bf16 rounding step may resolve one the other way, after which the two
    sequences are different texts and are compared no further."""
    cfg = _hf_config(vocab_size=256)
    _save_checkpoint(tmp_path / "ckpt", cfg, _state_dict(cfg, seed=3))
    out = _greedy_both(tmp_path / "ckpt", "W4A16_AWQ", logprobs=2)
    assert [len(t) for t in out["torch"]] == [16] * 3
    agreed = 0
    for ref, got, lps in zip(out["jax"], out["torch"], out["jax_logprobs"]):
        for a, b, lp in zip(ref, got, lps):
            if a != b:
                top = sorted(lp.values(), reverse=True)
                assert top[0] - top[1] <= 3e-2, (ref, got, lp)
                break
            agreed += 1
    assert agreed >= 24          # of 48: the streams agree at length


def _pack_nibbles(nib):
    shifts = np.arange(0, 32, 4, dtype=np.uint32)
    return (nib.astype(np.uint32) << shifts).sum(axis=-1, dtype=np.uint32) \
        .view(np.int32)


def _prequantize(sd, fmt, G):
    """Replace every layer projection of a float state dict by an
    AutoAWQ / AutoGPTQ 4-bit container (asymmetric min-max per group)."""
    from tensorrt_llm_tpu_torch.quantization.checkpoint import AWQ_ORDER
    out = {}
    for name, w in sd.items():
        if "_proj.weight" not in name:
            out[name] = w
            continue
        base = name[:-len(".weight")]
        wt = w.T                                           # [K, N]
        K, N = wt.shape
        g = wt.reshape(K // G, G, N)
        lo, hi = g.min(1, keepdims=True), g.max(1, keepdims=True)
        s = np.maximum((hi - lo) / 15.0, 1e-8).astype(np.float16)
        sf = s.astype(np.float32)
        z = np.clip(np.round(-lo / sf), 1, 15)
        q = np.clip(np.round(g / sf) + z, 0, 15).reshape(K, N) \
            .astype(np.uint8)
        z = z[:, 0, :].astype(np.uint8)
        if fmt == "awq":
            order = list(AWQ_ORDER)
            out[base + ".qweight"] = _pack_nibbles(
                q.reshape(K, N // 8, 8)[:, :, order])
            out[base + ".qzeros"] = _pack_nibbles(
                z.reshape(K // G, N // 8, 8)[:, :, order])
        else:
            out[base + ".qweight"] = _pack_nibbles(
                q.reshape(K // 8, 8, N).transpose(0, 2, 1))
            out[base + ".qzeros"] = _pack_nibbles(
                (z - 1).reshape(K // G, N // 8, 8))
        out[base + ".scales"] = s[:, 0, :]
    return out


@pytest.mark.parametrize("fmt", ["awq", "gptq"])
def test_llm_ingests_prequantized_checkpoint_as_jax_does(tmp_path, fmt):
    """A self-packed AutoAWQ / AutoGPTQ directory is served from its own
    integers, zero points and scales; the checkpoint's recipe overrides
    the (absent) quant_config in both packages."""
    cfg = _hf_config(vocab_size=256)
    qc = {"quant_method": fmt, "bits": 4, "group_size": 64}
    qc.update({"zero_point": True, "version": "gemm"} if fmt == "awq"
              else {"desc_act": False})
    _save_checkpoint(tmp_path / fmt, cfg,
                     _prequantize(_state_dict(cfg, seed=4), fmt, 64), qc)
    out = _greedy_both(tmp_path / fmt)
    algo = "W4A16_AWQ" if fmt == "awq" else "W4A16_GPTQ"
    assert out["torch_llm_algo"] == out["jax_llm_algo"] == algo
    assert out["torch"] == out["jax"]


def test_llm_refuses_what_is_not_ported(tmp_path):
    """What the JAX factory also refuses: SmoothQuant's per-tensor plugin
    and mixed precision; and an 8-bit GPTQ checkpoint."""
    import tensorrt_llm_tpu_torch as T
    cfg = _hf_config()
    for algo, word in [("W8A8_SQ_PER_TENSOR_PLUGIN", "SmoothQuant"),
                       ("MIXED_PRECISION", "mixed precision")]:
        with pytest.raises(NotImplementedError, match=word):
            T.LLM(cfg, device="cpu", quant_config=T.QuantConfig(
                quant_algo=T.QuantAlgo[algo]))
    _save_checkpoint(tmp_path, cfg, _state_dict(cfg), {
        "quant_method": "gptq", "bits": 8, "group_size": 64,
        "desc_act": False})
    with pytest.raises(NotImplementedError, match="4-bit only"):
        T.LLM(str(tmp_path), device="cpu", **_llm_kwargs())
