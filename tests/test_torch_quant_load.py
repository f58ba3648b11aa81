"""Weights quantized at load (FP8 per-tensor, FP8 block scales,
SmoothQuant W8A8, W4A8) in the port against the JAX package, on the CPU.

Covered: the quantizers (bit-identical bytes and integers; scales to
rtol 1e-6), each method's ``apply`` on parameters carried across by
``from_jax_params`` in float32 and bf16, fused against unfused
projections, the fp8 bytes carried across, prefill-then-decode logits of
a tiny Llama under each algorithm (and of a tiny Qwen3-MoE, whose
attention projections are quantized), greedy tokens of both ``LLM``s
(SmoothQuant through the same inline ``transformers`` module, whose
smoothing scales must agree), and the plain version of the
dequant-matmul kernel's e4m3 body.

Tolerances. float32: 1e-5 for a method's output (float32 sums in
another order), 1e-4 for logits through two layers. bf16: one bf16 step
(rtol 2**-7). The int8-product methods (SmoothQuant, W4A8) quantize
each token of x to int8: a float32 difference of one part in 1e7
upstream can move one element across a rounding boundary, one int8 step
of that token's scale, so their logits are held to 2e-3.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorrt_llm_tpu.llmapi.llm_args import QuantConfig as JQuantConfig
from tensorrt_llm_tpu.models.modeling_utils import \
    quantize_linear as jquantize_linear
from tensorrt_llm_tpu.ops import linear as jlinear
from tensorrt_llm_tpu.ops import quant as JQ
from tensorrt_llm_tpu.quantization.mode import QuantAlgo as JQuantAlgo
from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
from tensorrt_llm_tpu_torch.models.convert import carry_projection
from tensorrt_llm_tpu_torch.models.modeling_utils import quantize_linear
from tensorrt_llm_tpu_torch.ops import linear as tlinear
from tensorrt_llm_tpu_torch.ops import quant as TQ
from tensorrt_llm_tpu_torch.ops.cuda import quant_matmul as tqmm
from tensorrt_llm_tpu_torch.quantization.mode import QuantAlgo

ALGOS = ["FP8", "FP8_PER_CHANNEL_PER_TOKEN", "FP8_BLOCK_SCALES",
         "W8A8_SQ_PER_CHANNEL", "W4A8_AWQ"]
INT8_PRODUCT = ("W8A8_SQ_PER_CHANNEL", "W4A8_AWQ")
BF16_STEP = dict(rtol=2.0 ** -7, atol=1e-5)
F32 = dict(rtol=1e-5, atol=1e-5)


def _weight(K, N, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, N)) * 0.05).astype(np.float32)


def _fp8_bytes(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def _methods(algo, group=64):
    jm = jlinear.make_linear_method(JQuantConfig(
        quant_algo=JQuantAlgo[algo], group_size=group), "q_proj")
    tm = tlinear.make_linear_method(QuantConfig(
        quant_algo=QuantAlgo[algo], group_size=group), "q_proj")
    return jm, tm


# --------------------------------------------------------------------- #
# Quantizers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(256, 384), (200, 300)])
def test_fp8_quantizers_are_bit_identical(shape):
    w = _weight(*shape, seed=shape[0])
    w[3, 5], w[4, 4] = 1e-7, 3e-6           # e4m3 subnormals and zero
    tq, ts = TQ.quantize_weight_fp8(torch.from_numpy(w))
    jq, js = JQ.quantize_weight_fp8(jnp.asarray(w))
    assert tq.dtype == torch.float8_e4m3fn and ts.dim() == 0
    np.testing.assert_array_equal(_fp8_bytes(tq), _fp8_bytes(jq))
    assert float(ts) == pytest.approx(float(js), rel=1e-6)
    tq, ts = TQ.quantize_weight_fp8_blockwise(torch.from_numpy(w))
    jq, js = JQ.quantize_weight_fp8_blockwise(jnp.asarray(w))
    assert tq.shape == shape and tuple(ts.shape) == tuple(js.shape) == (
        -(-shape[0] // 128), -(-shape[1] // 128))
    np.testing.assert_array_equal(_fp8_bytes(tq), _fp8_bytes(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_token_int8_is_bit_identical(dtype):
    x = np.random.default_rng(1).standard_normal((7, 96)).astype(np.float32)
    x[2] = 0.0                               # the scale floor
    x[3, 0] = 40.0                           # an outlier channel
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tq, ts = TQ.quantize_activation_per_token_int8(tx)
    jq, js = JQ.quantize_activation_per_token_int8(jx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_w4a8_stores_the_int8_values_the_jax_apply_computes():
    jm, tm = _methods("W4A8_AWQ")
    w = _weight(256, 96, seed=7)
    jp = jm.quantize_weights(jnp.asarray(w))
    # the JAX apply's per-call rescale to the int8 grid
    w8 = (np.asarray(jp["weight"]).reshape(4, -1, 96).astype(np.float32)
          * np.asarray(jp["weight_scale"])[:, None, :])
    w8 = np.clip(np.round(w8), -127, 127).astype(np.int8).reshape(256, 96)
    tp = tm.quantize_weights(torch.from_numpy(w))
    assert sorted(tp) == ["channel_scale", "weight"]
    np.testing.assert_array_equal(tp["weight"].numpy(), w8)
    np.testing.assert_allclose(tp["channel_scale"].numpy(),
                               np.asarray(jp["channel_scale"]), rtol=1e-6)
    carried = carry_projection(jax.tree.map(np.asarray, jp))
    assert torch.equal(carried["weight"], tp["weight"])


# --------------------------------------------------------------------- #
# Methods
# --------------------------------------------------------------------- #
def _apply_case(algo, M, dtype, smooth):
    jm, tm = _methods(algo)
    rng = np.random.default_rng(M)
    K, N = 256, 96
    x = rng.standard_normal((2, M // 2, K)).astype(np.float32)
    x[..., 5] *= 20.0                        # an outlier channel
    s = (rng.random(K) + 0.5).astype(np.float32) if smooth else None
    jp = jquantize_linear(jm, _weight(K, N, seed=3), bias=None,
                          dtype=jnp.float32, smooth=s)
    jp["bias"] = rng.standard_normal(N).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    # the bias in the model's type, as the loaders keep it
    jtree = dict(jax.tree.map(jnp.asarray, jp),
                 bias=jnp.asarray(jp["bias"]).astype(dtype))
    want = np.asarray(jm.apply(jtree, jx).astype(jnp.float32))
    tp = carry_projection(jp, dtype=getattr(torch, dtype))
    got = tm.apply(tp, torch.from_numpy(x).to(getattr(torch, dtype)))
    return x, jp, tp, tm, want, got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [8, 200])
@pytest.mark.parametrize("algo,smooth", [(a, False) for a in ALGOS] + [
    (a, True) for a in INT8_PRODUCT])
def test_apply_matches_jax(algo, smooth, M, dtype):
    before = tqmm.LAUNCHES
    x, jp, tp, tm, want, got = _apply_case(algo, M, dtype, smooth)
    assert tqmm.LAUNCHES == before           # the CPU launches nothing
    assert got.shape == (2, M // 2, 96)
    assert got.dtype == getattr(torch, dtype)
    tol = F32 if dtype == "float32" else BF16_STEP
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_fp8_rounds_a_float32_x_to_bf16_as_the_jax_method_does():
    """FP8 per-tensor under a float32 model: both packages round x to
    bf16 before the product, so the result is not the float32 product
    of x with the dequantized weight."""
    x, jp, tp, tm, want, got = _apply_case("FP8", 8, "float32", False)
    exact = x @ tm.dequantize(tp, torch.float32).numpy() + jp["bias"]
    np.testing.assert_allclose(got.numpy(), want, **F32)
    assert np.abs(got.numpy() - exact).max() > 1e-3


@pytest.mark.parametrize("algo", ALGOS)
def test_dequantize_gives_the_effective_weight(algo):
    """``dequantize`` (how the EAGLE3 head and the drafters borrow a
    quantized lm_head): x @ dequantize == apply, to the method's
    rounding, smoothing included."""
    _, tm = _methods(algo)
    w = torch.from_numpy(_weight(256, 96, seed=5))
    s = torch.rand(256, generator=torch.Generator().manual_seed(0)) + 0.5
    p = quantize_linear(tm, w, dtype=torch.float32,
                        smooth=s if algo in INT8_PRODUCT else None)
    x = torch.randn((8, 256), generator=torch.Generator().manual_seed(1))
    ref = x @ tm.dequantize(p, torch.float32)
    torch.testing.assert_close(tm.apply(p, x), ref, rtol=0.05, atol=0.05)
    # half a grid step at the top: e4m3's 3-bit mantissa (a sixteenth
    # of the absmax, bounding 1/28), int8's (a 254th), and W4A8's int4
    # group step plus its int8 rounding (a fourteenth plus a 254th)
    # (of the smoothed weight's absmax, over the smallest s)
    step = {"W4A8_AWQ": 12, "W8A8_SQ_PER_CHANNEL": 200}.get(algo, 16)
    top = float((w * s[:, None]).abs().max() / s.min()) \
        if algo in INT8_PRODUCT else float(w.abs().max())
    torch.testing.assert_close(tm.dequantize(p, torch.float32), w, rtol=0,
                               atol=top / step)


@pytest.mark.parametrize("algo", ALGOS)
def test_fused_projections_equal_the_parts(algo):
    """q, k, v quantized apart and joined along N compute the parts'
    columns; a per-tensor FP8 scale is expanded over its part's columns.
    Block scales over part-blocks and smoothing vectors do not join."""
    from tensorrt_llm_tpu_torch.models.modeling_utils import \
        fuse_projections
    _, tm = _methods(algo)
    parts = [tm.quantize_weights(torch.from_numpy(_weight(256, n, seed=n)))
             for n in (256, 128, 128)]
    fused = fuse_projections("qkv", "qkv", (tm,) * 3, parts)
    assert list(fused) == ["qkv"]
    x = torch.randn((8, 256), generator=torch.Generator().manual_seed(2))
    want = torch.cat([tm.apply(p, x) for p in parts], dim=-1)
    torch.testing.assert_close(tm.apply(fused["qkv"], x), want,
                               rtol=1e-6, atol=1e-6)
    if algo == "FP8_BLOCK_SCALES":
        small = [tm.quantize_weights(torch.from_numpy(_weight(256, 64)))
                 for _ in range(2)]
        assert not tlinear.can_fuse(small)
    if algo in INT8_PRODUCT:
        s = torch.ones(256)
        smoothed = [quantize_linear(tm, torch.from_numpy(_weight(256, 128)),
                                    dtype=torch.float32, smooth=s)
                    for _ in range(2)]
        assert list(fuse_projections("gate_up", ("gate", "up"), (tm,) * 2,
                                     smoothed)) == ["gate", "up"]


# --------------------------------------------------------------------- #
# The e4m3 body's plain version
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("form", ["tensor", "column", "block"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_e4m3_plain_equals_dequantize_then_multiply(form, dtype):
    K, N, M = 384, 320, 5
    w = torch.from_numpy(_weight(K, N, seed=11))
    if form == "block":
        q, s = TQ.quantize_weight_fp8_blockwise(w)
        wd = TQ.dequantize_fp8_blockwise(q, s)
    else:
        q, s = TQ.quantize_weight_fp8(w)
        if form == "column":
            s = torch.linspace(0.5, 2.0, N) * s
        wd = q.float() * s
    x = torch.randn((M, K), generator=torch.Generator().manual_seed(3)).to(
        getattr(torch, dtype))
    got = tqmm.e4m3_dequant_matmul(x, q, s)
    assert got.dtype == x.dtype
    assert torch.equal(got, tqmm.e4m3_dequant_matmul_plain(x, q, s))
    ref = x.to(torch.bfloat16).double() @ wd.double()
    tol = F32 if dtype == "float32" else BF16_STEP
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), **tol)
    with pytest.raises(ValueError, match="none of"):
        tqmm.e4m3_dequant_matmul(x, q, torch.ones(3))


def test_every_finite_e4m3_code_is_exact_in_bf16():
    """The widening the e4m3 body relies on: each of the 254 finite
    codes (and both zeros) is a bf16 value."""
    codes = torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn)
    f = codes.float()
    finite = torch.isfinite(f)
    assert int(finite.sum()) == 254
    assert torch.equal(f[finite].to(torch.bfloat16).float(), f[finite])


# --------------------------------------------------------------------- #
# Models
# --------------------------------------------------------------------- #
def _same_tree(got, want, path=""):
    """Integers and fp8 bytes identical, floats to 1e-6."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}[{i}]")
    elif want.dtype == torch.float8_e4m3fn:
        assert got.dtype == want.dtype, path
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8)), \
            path
    elif want.dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7,
                                   msg=lambda m: f"{path}: {m}")
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), path


def _hf_module(cfg, sd):
    """The ``transformers`` Llama of ``cfg`` holding state dict ``sd``."""
    from transformers import LlamaForCausalLM
    m = LlamaForCausalLM(cfg).float().eval()
    m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                      strict=False)
    return m


MODEL_CASES = ALGOS + ["W8A8_SQ_PER_CHANNEL+smooth", "W4A8_AWQ+smooth"]


@pytest.mark.parametrize("case", MODEL_CASES)
def test_quantized_llama_logits_match_jax(monkeypatch, case):
    """A tiny Llama (hidden 256, intermediate 512) under each algorithm:
    the port's own load-time quantization equals the JAX tree carried
    across, and prefill-then-decode logits agree. ``+smooth``: smoothing
    scales calibrated on the ``transformers`` twin, folded by both."""
    from tensorrt_llm_tpu.quantization.smoothquant import \
        calibrate_smooth_scales as jcalibrate
    from tensorrt_llm_tpu.quantization.smoothquant import \
        default_calibration_ids
    from tensorrt_llm_tpu_torch.models import from_jax_params
    from tensorrt_llm_tpu_torch.quantization.smoothquant import \
        calibrate_smooth_scales
    from tests.test_torch_quant_model import (_hf_config, _models,
                                              _prefill_then_decode,
                                              _state_dict)
    monkeypatch.setenv("TLLM_TPU_PALLAS_INTERPRET", "1")
    algo, _, smooth = case.partition("+")
    cfg = _hf_config()
    sd = _state_dict(cfg, seed=2)
    jm, tm = _models(cfg, algo)
    if smooth:
        module = _hf_module(cfg, sd)
        ids = default_calibration_ids(cfg.vocab_size)
        scales = calibrate_smooth_scales(module, ids)
        want = jcalibrate(module, ids)
        assert sorted(scales) == sorted(want)
        for k in want:
            np.testing.assert_allclose(scales[k], want[k], rtol=1e-6)
        jm.smooth_scales, tm.smooth_scales = want, scales
    jparams = jm.load_hf_state_dict(sd)
    carried = from_jax_params(jax.tree.map(np.asarray, jparams))
    own = tm.load_hf_state_dict(sd)
    _same_tree(own, carried)
    layer = own["layers"][0]
    if smooth:
        assert {"q", "k", "v", "gate", "up"} <= set(layer)
        assert "qkv" not in layer and "gate_up" not in layer
        assert layer["q"]["smooth"].dtype == torch.float32
    else:
        assert {"qkv", "gate_up"} <= set(layer)
    want, got = _prefill_then_decode(jm, jparams, tm, own, cfg.vocab_size)
    atol = 2e-3 if algo in INT8_PRODUCT else 1e-4
    for g, w in zip(got, want):
        assert np.abs(w).max() > 0.05
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


@pytest.mark.parametrize("algo", ["FP8", "W8A8_SQ_PER_CHANNEL"])
def test_quantized_qwen3_moe_attention_matches_jax(tmp_path, monkeypatch,
                                                   algo):
    """A tiny Qwen3-MoE: the attention projections are quantized, the
    experts stay in the model's type, as in the JAX MixtralForCausalLM."""
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file

    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu_torch.models import ModelConfig as TConfig
    from tensorrt_llm_tpu_torch.models import from_jax_params
    from tensorrt_llm_tpu_torch.models import get_model_class as tget
    from tests.test_torch_dense_families import prefill_then_decode
    from tests.test_torch_families import save_random
    monkeypatch.setenv("TLLM_TPU_PALLAS_INTERPRET", "1")
    cfg, _ = save_random(tmp_path, "qwen3_moe")
    st = str(tmp_path / "model.safetensors")
    jm = jget(cfg.model_type)(JConfig(
        hf_config=cfg, dtype=jnp.float32,
        quant_config=JQuantConfig(quant_algo=JQuantAlgo[algo])))
    tm = tget(cfg.model_type)(TConfig(
        hf_config=cfg, dtype=torch.float32, device="cpu",
        quant_config=QuantConfig(quant_algo=QuantAlgo[algo])))
    jparams = jm.load_hf_state_dict(dict(np_load(st)))
    own = tm.load_hf_state_dict(load_file(st))
    _same_tree(own, from_jax_params(jax.tree.map(np.asarray, jparams)))
    layer = own["layers"][0]
    assert layer["o"]["weight"].dtype == (
        torch.float8_e4m3fn if algo == "FP8" else torch.int8)
    assert layer["w_gate_up"].dtype == torch.float32
    want, got = prefill_then_decode(jm, jparams, tm, own)
    atol = 2e-3 if algo in INT8_PRODUCT else 1e-4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


# --------------------------------------------------------------------- #
# LLM
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("algo", ALGOS)
def test_llm_greedy_matches_jax(algo):
    """The trained parity checkpoint in float32 through both packages'
    ``LLM``; SmoothQuant through the inline-model entry, with the same
    ``transformers`` module given to both (its smoothing scales agree,
    and q, k, v stay apart). W4A8 at group 16 (intermediate 688 is 43
    groups of 16)."""
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    from tests.test_torch_quant_model import CKPT, PROMPTS, _llm_kwargs
    model = str(CKPT)
    if algo == "W8A8_SQ_PER_CHANNEL":
        from transformers import LlamaForCausalLM
        model = LlamaForCausalLM.from_pretrained(
            CKPT, torch_dtype=torch.float32).eval()
    out, llms = {}, {}
    for name, pkg, extra in (("jax", J, {}), ("torch", T,
                                              dict(device="cpu"))):
        llm = pkg.LLM(model, kv_cache_config=pkg.KvCacheConfig(
            tokens_per_block=16, max_tokens=1024),
            quant_config=pkg.QuantConfig(quant_algo=pkg.QuantAlgo[algo],
                                         group_size=16),
            **extra, **_llm_kwargs())
        try:
            res = llm.generate(PROMPTS, pkg.SamplingParams(max_tokens=16,
                                                           top_k=1))
            out[name] = [r.outputs[0].token_ids for r in res]
            llms[name] = llm.model
        finally:
            llm.shutdown()
    assert [len(t) for t in out["torch"]] == [16] * 3
    assert out["torch"] == out["jax"]
    if algo == "W8A8_SQ_PER_CHANNEL":
        want = llms["jax"].smooth_scales
        got = llms["torch"].smooth_scales
        assert len(want) == 6 * 7 + 1 and sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_llm_inline_module_serves_its_state_dict():
    """``LLM(model=<transformers model>)`` reads the module's weights
    (greedy tokens equal to the checkpoint directory's), and with
    ``load_format="dummy"`` serves seeded random ones instead."""
    import tensorrt_llm_tpu_torch as T
    from transformers import LlamaForCausalLM
    from tests.test_torch_quant_model import CKPT, PROMPTS, _llm_kwargs
    module = LlamaForCausalLM.from_pretrained(
        CKPT, torch_dtype=torch.float32).eval()
    out = []
    for model, extra in ((str(CKPT), {}), (module, {}),
                         (module, dict(load_format="dummy"))):
        llm = T.LLM(model, device="cpu", kv_cache_config=T.KvCacheConfig(
            tokens_per_block=16, max_tokens=1024), **extra, **_llm_kwargs())
        try:
            res = llm.generate(PROMPTS[:1], T.SamplingParams(max_tokens=8,
                                                             top_k=1))
            out.append(res[0].outputs[0].token_ids)
        finally:
            llm.shutdown()
    assert out[0] == out[1] and out[2] != out[0]
