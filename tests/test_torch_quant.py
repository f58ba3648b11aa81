"""Weight-only quantization of the port against the JAX package, on the
CPU: the quantizers, int4 packing, the dequant-matmul kernel's plain
version against the Pallas kernel in interpret mode, every linear method's
``apply`` on parameters carried across, and AWQ / GPTQ container
ingestion on containers packed here from a seed.

Tolerances. Quantized integers: bit-identical. Scales: rtol 1e-6. The
kernel route rounds its float32 sum to bf16 on both sides, and sums taken
in another order can land on neighbouring bf16 values: rtol 2**-7 (one
bf16 step), atol 1e-5. The dequantize-then-matmul route is float32 on
both sides: 1e-4 (sums in another order). NVFP4 at M <= 128 runs the
kernel's arithmetic (bf16 activations) in the port but the float32 dot in
the JAX package, whose Pallas kernel cannot tile groups of 16: 2e-2.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.llmapi.llm_args import QuantConfig as JQuantConfig
from tensorrt_llm_tpu.ops import linear as jlinear
from tensorrt_llm_tpu.ops import quant as JQ
from tensorrt_llm_tpu.ops.pallas import quant_matmul as jqmm
from tensorrt_llm_tpu.quantization import checkpoint as jckpt
from tensorrt_llm_tpu.quantization.mode import QuantAlgo as JQuantAlgo
from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
from tensorrt_llm_tpu_torch.ops import linear as tlinear
from tensorrt_llm_tpu_torch.ops import quant as TQ
from tensorrt_llm_tpu_torch.ops.cuda import quant_matmul as tqmm
from tensorrt_llm_tpu_torch.quantization import checkpoint as tckpt
from tensorrt_llm_tpu_torch.quantization.mode import QuantAlgo

BF16_STEP = dict(rtol=2.0 ** -7, atol=1e-5)
F32_SUMS = dict(rtol=1e-4, atol=1e-4)
ALGOS = ["W8A16", "W4A16", "W4A16_AWQ", "W4A16_GPTQ", "NVFP4", "MXFP4"]


def _weight(K, N, seed=0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, N)) * 0.05 + shift).astype(np.float32)


def _same_ints(t: torch.Tensor, j) -> None:
    j = np.asarray(j)
    np.testing.assert_array_equal(t.numpy().astype(np.int32),
                                  j.astype(np.int32))


def _same_scales(t: torch.Tensor, j) -> None:
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=0)


# --------------------------------------------------------------------- #
# Quantizers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("bits", [8, 4])
def test_per_channel_quantizer_is_bit_identical(bits):
    w = _weight(192, 96, seed=bits)
    tq, ts = TQ.quantize_weight_per_channel(torch.from_numpy(w), bits=bits)
    jq, js = JQ.quantize_weight_per_channel(jnp.asarray(w), bits=bits)
    assert tq.dtype == torch.int8
    _same_ints(tq, jq)
    _same_scales(ts, js)
    back = TQ.dequantize_weight(tq, ts, dtype=torch.float32)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(JQ.dequantize_weight(
            jq.astype(jnp.int8), js, dtype=jnp.float32)), rtol=1e-6)


@pytest.mark.parametrize("group,bits,asym", [
    (32, 4, False), (64, 4, False), (128, 4, False), (64, 4, True),
    (128, 4, True), (64, 8, False)])
def test_groupwise_quantizer_is_bit_identical(group, bits, asym):
    w = _weight(256, 80, seed=group + bits, shift=0.02 if asym else 0.0)
    tq, ts, tz = TQ.quantize_weight_groupwise(
        torch.from_numpy(w), group_size=group, bits=bits, asymmetric=asym)
    jq, js, jz = JQ.quantize_weight_groupwise(
        jnp.asarray(w), group_size=group, bits=bits, asymmetric=asym)
    _same_ints(tq, jq)
    _same_scales(ts, js)
    assert (tz is None) == (jz is None) == (not asym)
    if asym:
        _same_ints(tz, jz)               # zero points are whole numbers
    back = TQ.dequantize_weight(tq, ts, zeros=tz, group_size=group,
                                dtype=torch.float32)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(JQ.dequantize_weight(
            jq, js, zeros=jz, group_size=group, dtype=jnp.float32)),
        rtol=1e-6, atol=1e-9)


def test_groupwise_quantizer_refuses_ragged_k():
    with pytest.raises(ValueError, match="not divisible"):
        TQ.quantize_weight_groupwise(torch.zeros(100, 8), group_size=64)


@pytest.mark.parametrize("group,fmt", [(16, "e4m3"), (32, "e8m0")])
def test_fp4_quantizer_is_bit_identical(group, fmt):
    w = _weight(128, 72, seed=group)
    w[:group, 3] = 0.0                            # an all-zero group
    tq, ts = TQ.quantize_weight_fp4(torch.from_numpy(w), group_size=group,
                                    scale_fmt=fmt)
    jq, js = JQ.quantize_weight_fp4(jnp.asarray(w), group_size=group,
                                    scale_fmt=fmt)
    _same_ints(tq, jq)
    _same_scales(ts, js)
    assert set(np.unique(np.abs(tq.numpy()))) <= {0, 1, 2, 3, 4, 6, 8, 12}


def test_fp4_round_matches_jax_on_grid_ties_and_saturation():
    x = np.concatenate([
        np.linspace(-7.0, 7.0, 561),
        np.array([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0, -0.25, -5.0, 100.0])
    ]).astype(np.float32)
    np.testing.assert_array_equal(
        TQ.fp4_round(torch.from_numpy(x)).numpy(),
        np.asarray(JQ.fp4_round(jnp.asarray(x))))


def test_pack_int4_round_trips_and_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, size=(64, 40)).astype(np.int8)
    q[0, :16] = np.arange(-8, 8)                  # every nibble value
    q[32, :16] = np.arange(-8, 8)[::-1]
    packed = TQ.pack_int4(torch.from_numpy(q))
    assert packed.shape == (32, 40) and packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jqmm.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(TQ.unpack_int4(packed).numpy(), q)
    np.testing.assert_array_equal(
        TQ.unpack_int4(packed).numpy(),
        np.asarray(jqmm.unpack_int4(jnp.asarray(packed.numpy()))))
    with pytest.raises(ValueError, match="even"):
        TQ.pack_int4(torch.zeros(3, 4, dtype=torch.int8))


# --------------------------------------------------------------------- #
# The kernel's plain version against the Pallas kernel (interpret mode)
# --------------------------------------------------------------------- #
def _kernel_case(M, K, N, G, bits, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q, s, _ = JQ.quantize_weight_groupwise(jnp.asarray(_weight(K, N, seed)),
                                           group_size=G, bits=bits)
    if bits == 4:
        q = jqmm.pack_int4(q)
    return x, np.array(q), np.array(s)            # writable copies


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [1, 8, 128])
@pytest.mark.parametrize("G,K,N", [(32, 256, 200), (64, 256, 384),
                                   (128, 512, 257)])
def test_plain_kernel_matches_pallas_interpret(bits, M, G, K, N):
    x, q, s = _kernel_case(M, K, N, G, bits, seed=M + G)
    ref = jqmm.groupwise_dequant_matmul(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), group_size=G,
        bits=bits, interpret=True)
    args = (torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s))
    plain = tqmm.groupwise_dequant_matmul_plain(*args, group_size=G,
                                                bits=bits)
    before = tqmm.LAUNCHES
    wrapped = tqmm.groupwise_dequant_matmul(*args, group_size=G, bits=bits)
    assert tqmm.LAUNCHES == before            # CPU tensors launch nothing
    assert plain.dtype == torch.bfloat16 and plain.shape == (M, N)
    assert ref.dtype == jnp.bfloat16          # for float32 x too
    assert torch.equal(plain, wrapped)
    np.testing.assert_allclose(plain.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **BF16_STEP)


def test_plain_kernel_takes_bf16_activations():
    x, q, s = _kernel_case(8, 256, 96, 64, 4, seed=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tqmm.groupwise_dequant_matmul(xb, torch.from_numpy(q),
                                        torch.from_numpy(s), group_size=64)
    ref = jqmm.groupwise_dequant_matmul(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(q), jnp.asarray(s),
        group_size=64, bits=4, interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **BF16_STEP)


@pytest.mark.parametrize("bits", [4, 8])
def test_more_than_128_rows_take_the_dequant_route(bits):
    x, q, s = _kernel_case(129, 256, 200, 64, bits, seed=9)
    ref = jqmm.groupwise_dequant_matmul(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), group_size=64,
        bits=bits, interpret=True)
    got = tqmm.groupwise_dequant_matmul(
        torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
        group_size=64, bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_SUMS)
    # float32 all the way: not the bf16-rounded kernel arithmetic
    plain = tqmm.groupwise_dequant_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(s),
        group_size=64, bits=bits)
    assert got.dtype == torch.float32 and not torch.equal(got, plain.float())


def test_kernel_contract_and_shape_checks():
    assert tqmm.kernel_takes(128, 2048, 128, 4)
    assert tqmm.kernel_takes(1, 64, 16, 8)
    assert not tqmm.kernel_takes(129, 2048, 128, 4)      # rows
    assert not tqmm.kernel_takes(8, 688, 16, 4)          # K % 2G
    assert tqmm.kernel_takes(8, 688, 16, 8)
    assert not tqmm.kernel_takes(8, 2048, 256, 8)        # group size
    x = torch.zeros(4, 128)
    w = torch.zeros(64, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="scales"):
        tqmm.groupwise_dequant_matmul(x, w, torch.zeros(3, 8), group_size=64)
    with pytest.raises(ValueError, match="weight rows"):
        tqmm.groupwise_dequant_matmul(x, w, torch.zeros(2, 8), group_size=64,
                                      bits=8)
    with pytest.raises(TypeError, match="int8"):
        tqmm.groupwise_dequant_matmul(x, w.float(), torch.zeros(2, 8),
                                      group_size=64)


# --------------------------------------------------------------------- #
# Linear methods
# --------------------------------------------------------------------- #
def _methods(algo, group=64, name="q_proj"):
    jm = jlinear.make_linear_method(
        JQuantConfig(quant_algo=JQuantAlgo[algo], group_size=group), name)
    tm = tlinear.make_linear_method(
        QuantConfig(quant_algo=QuantAlgo[algo], group_size=group), name)
    return jm, tm


def _carry(jparams):
    """A JAX projection's parameters as tensors (int4 widened to int8)."""
    out = {}
    for k, v in jparams.items():
        a = np.asarray(v)
        if a.dtype.kind not in "fiub":
            a = a.astype(np.int8)
        out[k] = torch.from_numpy(np.array(a))
    return out


@pytest.mark.parametrize("algo", ALGOS)
def test_quantize_weights_matches_jax(algo):
    jm, tm = _methods(algo)
    w = _weight(256, 96, seed=len(algo), shift=0.01)
    want = _carry(jm.quantize_weights(jnp.asarray(w), dtype=jnp.float32))
    got = tm.quantize_weights(torch.from_numpy(w), dtype=torch.float32)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k == "weight_scale":
            _same_scales(got[k], want[k].numpy())
        else:
            _same_ints(got[k], want[k].numpy())


@pytest.mark.parametrize("M", [8, 200], ids=["kernel_rows", "prefill_rows"])
@pytest.mark.parametrize("algo", ALGOS)
def test_linear_apply_matches_jax_on_carried_params(monkeypatch, algo, M):
    """M = 8 takes the kernel route where there is one (the JAX side in
    Pallas interpret mode), M = 200 the dequantize-then-matmul route."""
    monkeypatch.setenv("TLLM_TPU_PALLAS_INTERPRET", "1")
    jm, tm = _methods(algo)
    rng = np.random.default_rng(M)
    x = rng.standard_normal((2, M // 2, 256)).astype(np.float32)
    bias = rng.standard_normal(96).astype(np.float32)
    jparams = jm.quantize_weights(jnp.asarray(_weight(256, 96, seed=3)),
                                  dtype=jnp.float32)
    jparams["bias"] = jnp.asarray(bias)
    want = np.asarray(jm.apply(jparams, jnp.asarray(x)).astype(jnp.float32))
    before = tqmm.LAUNCHES
    got = tm.apply(_carry(jparams), torch.from_numpy(x))
    assert tqmm.LAUNCHES == before
    assert got.shape == (2, M // 2, 96) and got.dtype == torch.float32
    assert want.dtype == np.float32           # bf16 + float32 bias
    kernel = M <= 128 and algo in ("W4A16_AWQ", "MXFP4", "NVFP4")
    if algo == "NVFP4" and kernel:
        tol = dict(rtol=2e-2, atol=2e-2)
    else:
        tol = BF16_STEP if kernel else F32_SUMS
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_unquantized_method_keeps_out_in_layout():
    tm = tlinear.make_linear_method(None)
    w = _weight(64, 24)
    p = tm.quantize_weights(torch.from_numpy(w), dtype=torch.float32)
    assert p["weight"].shape == (24, 64) and p["weight"].is_contiguous()
    x = torch.from_numpy(_weight(5, 64, seed=1))
    np.testing.assert_allclose(tm.apply(p, x).numpy(), x.numpy() @ w,
                               rtol=1e-5, atol=1e-6)


def test_make_linear_method_excludes_by_name_and_refuses_by_name():
    qc = QuantConfig(quant_algo=QuantAlgo.W4A16_AWQ, group_size=32,
                     exclude_modules=["lm_head", "k_proj"])
    assert type(tlinear.make_linear_method(qc, "lm_head")) \
        is tlinear.LinearMethod
    assert type(tlinear.make_linear_method(qc, "k_proj")) \
        is tlinear.LinearMethod
    m = tlinear.make_linear_method(qc, "q_proj")
    assert isinstance(m, tlinear.WeightOnlyGroupwiseMethod)
    assert m.group_size == 32 and not m.asymmetric
    assert m.same_as(tlinear.make_linear_method(qc, "o_proj"))
    assert not m.same_as(tlinear.make_linear_method(qc, "k_proj"))
    # what the JAX factory refuses stays refused by name (QuantConfig
    # itself parses both names)
    for algo, word in [("W8A8_SQ_PER_TENSOR_PLUGIN", "SmoothQuant"),
                       ("MIXED_PRECISION", "mixed precision")]:
        with pytest.raises(NotImplementedError, match=word):
            tlinear.make_linear_method(QuantConfig(
                quant_algo=QuantAlgo[algo]), "q_proj")


def test_fusing_separately_quantized_projections_is_exact():
    """q, k, v quantized apart and joined along N give the same product
    as three separate applies (scales are per column; packing runs along
    K)."""
    _, tm = _methods("W4A16_AWQ")
    parts = [tm.quantize_weights(torch.from_numpy(_weight(256, n, seed=n)))
             for n in (64, 32, 32)]
    fused = tm.fuse(parts)
    assert fused["weight"].shape == (128, 128)
    x = torch.from_numpy(_weight(8, 256, seed=7))
    want = torch.cat([tm.apply(p, x) for p in parts], dim=-1)
    assert torch.equal(tm.apply(fused, x), want)


# --------------------------------------------------------------------- #
# AWQ / GPTQ containers, packed here
# --------------------------------------------------------------------- #
def _pack_nibbles(nib):
    """u8[..., 8] -> i32[...] with nibble i at bits 4i."""
    shifts = np.arange(0, 32, 4, dtype=np.uint32)
    return (nib.astype(np.uint32) << shifts).sum(axis=-1, dtype=np.uint32) \
        .view(np.int32)


def _container(fmt, K=128, N=64, G=32, seed=0, v2=False):
    """(tensors of one projection in the container's layout, the logical
    unsigned weight [K, N], zero points [K/G, N], scales [K/G, N])."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 16, size=(K, N)).astype(np.uint8)
    z = rng.integers(1, 16, size=(K // G, N)).astype(np.uint8)
    s = (rng.random((K // G, N)) * 0.02 + 0.001).astype(np.float16)
    if fmt == "awq":
        order = list(tckpt.AWQ_ORDER)
        qweight = _pack_nibbles(w.reshape(K, N // 8, 8)[:, :, order])
        qzeros = _pack_nibbles(z.reshape(K // G, N // 8, 8)[:, :, order])
    else:
        qweight = _pack_nibbles(w.reshape(K // 8, 8, N).transpose(0, 2, 1))
        stored = z if v2 else z - 1
        qzeros = _pack_nibbles(stored.reshape(K // G, N // 8, 8))
    return {"qweight": qweight, "qzeros": qzeros, "scales": s}, w, z, s


def _same_prequant(t, j):
    np.testing.assert_array_equal(t.weight, j.weight)
    np.testing.assert_array_equal(t.weight_scale, j.weight_scale)
    np.testing.assert_array_equal(t.weight_zero, j.weight_zero)
    assert (t.group_size, t.bits) == (j.group_size, j.bits)
    assert t.weight.dtype == np.int8 and t.weight_scale.dtype == np.float32


@pytest.mark.parametrize("fmt,v2", [("awq", False), ("gptq", False),
                                    ("gptq", True)])
def test_unpackers_match_jax_and_the_logical_values(fmt, v2):
    c, w, z, s = _container(fmt, v2=v2)
    if fmt == "awq":
        got = tckpt.unpack_awq_gemm(c["qweight"], c["qzeros"], c["scales"], 32)
        ref = jckpt.unpack_awq_gemm(c["qweight"], c["qzeros"], c["scales"],
                                    32)
    else:
        got = tckpt.unpack_gptq(c["qweight"], c["qzeros"], c["scales"], 32,
                                v2=v2)
        ref = jckpt.unpack_gptq(c["qweight"], c["qzeros"], c["scales"], 32,
                                bits=4, v2=v2)
    _same_prequant(got, ref)
    np.testing.assert_array_equal(got.weight, w.astype(np.int8))
    np.testing.assert_array_equal(got.weight_zero, z.astype(np.float32))
    np.testing.assert_array_equal(
        tckpt.dequantize_prequant(got),
        ((w.astype(np.float32).reshape(4, 32, 64) - z[:, None, :])
         * s.astype(np.float32)[:, None, :]).reshape(128, 64))
    # CPU tensors, as safetensors.torch hands them over, unpack alike
    as_t = {k: torch.from_numpy(v) for k, v in c.items()}
    again = tckpt.unpack_awq_gemm(as_t["qweight"], as_t["qzeros"],
                                  as_t["scales"], 32) if fmt == "awq" else \
        tckpt.unpack_gptq(as_t["qweight"], as_t["qzeros"], as_t["scales"],
                          32, v2=v2)
    _same_prequant(again, ref)


@pytest.mark.parametrize("fmt", ["awq", "gptq"])
def test_convert_state_dict_matches_jax(fmt):
    sd = {"model.norm.weight": np.ones(8, np.float32),
          "lm_head.weight": _weight(16, 8)}
    for i, name in enumerate(["model.layers.0.self_attn.q_proj",
                              "model.layers.0.mlp.down_proj"]):
        c, *_ = _container(fmt, seed=i)
        sd.update({f"{name}.{k}": v for k, v in c.items()})
        sd[f"{name}.g_idx"] = np.zeros(128, np.int32)
    tcfg = tckpt.PrequantConfig(fmt=fmt, quant_algo=QuantAlgo.W4A16_AWQ,
                                group_size=32)
    jcfg = jckpt.PrequantConfig(fmt=fmt, quant_algo=JQuantAlgo.W4A16_AWQ,
                                group_size=32)
    got = tckpt.convert_state_dict(sd, tcfg)
    ref = jckpt.convert_state_dict(sd, jcfg)
    assert sorted(got) == sorted(ref)
    for name, v in ref.items():
        if isinstance(v, jckpt.PrequantizedWeight):
            assert isinstance(got[name], tckpt.PrequantizedWeight)
            _same_prequant(got[name], v)
        else:
            assert got[name] is sd[name]
    with pytest.raises(ValueError, match="scales"):
        tckpt.convert_state_dict({"a.qweight": sd[
            "model.layers.0.self_attn.q_proj.qweight"]}, tcfg)


def _write_config(path, quantization_config=None):
    cfg = {"model_type": "llama"}
    if quantization_config is not None:
        cfg["quantization_config"] = quantization_config
    (path / "config.json").write_text(json.dumps(cfg))


@pytest.mark.parametrize("qc", [
    None,
    {"quant_method": "awq", "bits": 4, "group_size": 64, "zero_point": True,
     "version": "GEMM", "modules_to_not_convert": ["lm_head", "gate"]},
    {"quant_method": "gptq", "bits": 4, "group_size": 32, "desc_act": False},
    {"quant_method": "gptq", "bits": 4, "group_size": 128,
     "checkpoint_format": "gptq_v2"},
], ids=["plain", "awq", "gptq", "gptq_v2"])
def test_detect_prequantized_matches_jax(tmp_path, qc):
    _write_config(tmp_path, qc)
    got = tckpt.detect_prequantized(tmp_path)
    ref = jckpt.detect_prequantized(tmp_path)
    if qc is None:
        assert got is None and ref is None
        return
    assert got.quant_algo.value == ref.quant_algo.value
    for field in ("fmt", "group_size", "has_zero_point", "gptq_v2",
                  "exclude_modules"):
        assert getattr(got, field) == getattr(ref, field), field


def test_detect_prequantized_refusals(tmp_path):
    _write_config(tmp_path, {"quant_method": "gptq", "bits": 4,
                             "desc_act": True})
    with pytest.raises(NotImplementedError, match="act-order"):
        tckpt.detect_prequantized(tmp_path)
    _write_config(tmp_path, {"quant_method": "gptq", "bits": 8})
    with pytest.raises(NotImplementedError, match="4-bit"):
        tckpt.detect_prequantized(tmp_path)
    _write_config(tmp_path, {"quant_method": "awq", "bits": 4,
                             "version": "marlin"})
    with pytest.raises(NotImplementedError, match="marlin"):
        tckpt.detect_prequantized(tmp_path)
    _write_config(tmp_path)
    (tmp_path / "hf_quant_config.json").write_text(json.dumps(
        {"quantization": {"quant_algo": "FP8"}}))
    with pytest.raises(NotImplementedError, match="ModelOpt"):
        tckpt.detect_prequantized(tmp_path)
