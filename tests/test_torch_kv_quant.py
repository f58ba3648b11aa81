"""The quantized KV cache of the port (INT8, FP8, NVFP4 grid) against the
JAX package, on the CPU, below the ``LLM``: inputs from a seeded numpy
generator go through both packages (the ``LLM`` tests are in
tests/test_torch_kv_quant_llm.py).

- ``fp4_round``: equal on the e2m1 grid's midpoints (ties to the larger
  magnitude) and past its top (saturation at 6).
- ``write_kv``: the stored bytes equal the JAX ``write_kv``'s for values
  inside the pool type's range, float32 and bf16 inputs, int8, e4m3 and
  e4m3 on the NVFP4 grid, one scale or K and V apart. Reference fault 1:
  the JAX e4m3 cast gives NaN past about 464 (ml_dtypes saturates
  nothing); the port clamps to 448.
- The plain decode and prefill kernels and ``ragged_paged_attention`` on
  int8 and e4m3 pools against the JAX Pallas kernels in interpret mode and
  the JAX ``_reference_attention`` (hd 64 and 256, a window with a soft
  cap, sinks): float32 to 1e-5, bf16 to 2e-2 (bf16 rounding of the
  dequantized K/V and of the output, sums in another order).
- ``ModelConfig``: each algorithm's pool type, default scale and grid
  flag; the default pool holds twice the pages in the same bytes.
- Refusals: an unknown KV algorithm, and a ModelOpt container, by name.
"""
import json
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.ops import attention as jattn
from tensorrt_llm_tpu.ops.pallas.decode_attention import \
    paged_decode_attention as jax_decode
from tensorrt_llm_tpu.ops.pallas.prefill_attention import \
    ragged_prefill_attention as jax_prefill
from tensorrt_llm_tpu.ops.quant import fp4_round as jax_fp4_round
from tensorrt_llm_tpu_torch.ops import attention as tattn
from tensorrt_llm_tpu_torch.ops.cuda.decode_attention import \
    paged_decode_attention_plain
from tensorrt_llm_tpu_torch.ops.cuda.prefill_attention import \
    ragged_prefill_attention_plain
from tensorrt_llm_tpu_torch.ops.quant import fp4_round

CKPT = Path(__file__).parent / "assets" / "tinycode-llama"
TOLS = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# per 8-bit pool kind, (k_scale, v_scale) of the kernel cases: different
# for K and V
SCALES = {"int8": (0.04, 0.03), "e4m3": (0.02, 0.015)}


def _np_to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array (ml_dtypes e4m3 included) as a torch tensor."""
    if a.dtype == ml_dtypes.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.ascontiguousarray(a))


def _bytes(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    return np.asarray(t).view(np.uint8)


def _codes(pool) -> np.ndarray:
    """An 8-bit pool's values as integers in their order (int8 as they
    are; e4m3 sign and magnitude, +0 and -0 alike), so that neighbouring
    values differ by one."""
    b = _bytes(pool).astype(np.int64)
    if pool.dtype in (torch.int8, jnp.int8):
        return np.where(b > 127, b - 256, b)
    return np.where(b > 127, -(b & 0x7F), b)


# --------------------------------------------------------------------- #
# fp4_round and write_kv
# --------------------------------------------------------------------- #
def test_fp4_round_matches_jax_at_the_midpoints():
    grid = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], np.float32)
    mids = (grid[:-1] + grid[1:]) / 2
    x = np.concatenate([mids, -mids, np.nextafter(mids, 0), grid, -grid,
                        [5.99, 6.0, 6.01, 7.0, 1e4, -1e4, -0.1, 0.2]])
    x = x.astype(np.float32)
    want = np.asarray(jax_fp4_round(jnp.asarray(x)))
    got = fp4_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def _kv_inputs(dtype: str, seed: int = 0, T: int = 7, kvh: int = 2,
               hd: int = 64):
    """k, v [T, kvh, hd] of std 3 in ``dtype`` (bf16 values rounded once,
    in torch, and handed to JAX exactly), and slots with two dropped."""
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.standard_normal((T, kvh, hd)).astype(
        np.float32) * 3)
    v = torch.from_numpy(rng.standard_normal((T, kvh, hd)).astype(
        np.float32) * 3)
    if dtype == "bfloat16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    slots = np.array([3, 17, 100, 0, 5, 19, 20][:T], np.int32)
    return k, v, slots


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,scale", [("int8", 0.05), ("fp8", 0.04),
                                        ("nvfp4", 0.9)])
def test_write_kv_stores_the_jax_bytes(kind, scale, dtype):
    """int8 clips (both packages), the NVFP4 grid saturates at 6 (both);
    e4m3 values stay inside +-448 (std 3 over 0.04: at most ~340)."""
    k, v, slots = _kv_inputs(dtype)
    pdt = torch.int8 if kind == "int8" else torch.float8_e4m3fn
    jdt = jnp.int8 if kind == "int8" else jnp.float8_e4m3fn
    shape = (5, 4, 4, 64)
    sc = np.float32(scale)
    jpool = jattn.write_kv(jnp.zeros(shape, jdt), _jnp(k), _jnp(v),
                           jnp.asarray(slots), k_scale=sc, v_scale=sc,
                           fp4_grid=kind == "nvfp4")
    tpool = torch.zeros(shape, dtype=pdt)
    ts = torch.tensor(scale, dtype=torch.float32)
    tattn.write_kv(tpool, k, v, torch.from_numpy(slots), k_scale=ts,
                   v_scale=ts, fp4_grid=kind == "nvfp4")
    np.testing.assert_array_equal(_bytes(tpool), _bytes(jpool))
    assert _bytes(tpool).any()


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_write_kv_with_separate_k_and_v_scales(kind):
    k, v, slots = _kv_inputs("float32", seed=1)
    pdt = torch.int8 if kind == "int8" else torch.float8_e4m3fn
    jdt = jnp.int8 if kind == "int8" else jnp.float8_e4m3fn
    shape = (5, 4, 4, 64)
    jpool = jattn.write_kv(jnp.zeros(shape, jdt), _jnp(k), _jnp(v),
                           jnp.asarray(slots), k_scale=np.float32(0.05),
                           v_scale=np.float32(0.07))
    tpool = torch.zeros(shape, dtype=pdt)
    tattn.write_kv(tpool, k, v, torch.from_numpy(slots),
                   k_scale=torch.tensor(0.05), v_scale=torch.tensor(0.07))
    np.testing.assert_array_equal(_bytes(tpool), _bytes(jpool))


def test_write_kv_e4m3_saturates_where_jax_gives_nan():
    """Reference fault 1: values past e4m3's range. The JAX cast gives
    NaN for 500 and -1000 (after the scale); the port stores +-448, and
    equals JAX inside the range."""
    scale = 0.05
    k = torch.tensor([500.0, -1000.0, 440.0, 1.0],
                     dtype=torch.float32).mul(scale).reshape(4, 1, 1)
    k = k.expand(4, 1, 16).contiguous()
    slots = np.arange(4, dtype=np.int32)
    shape = (1, 4, 2, 16)
    sc = np.float32(scale)
    jpool = np.asarray(jattn.write_kv(
        jnp.zeros(shape, jnp.float8_e4m3fn), _jnp(k), _jnp(k),
        jnp.asarray(slots), k_scale=sc, v_scale=sc)).astype(np.float32)
    tpool = torch.zeros(shape, dtype=torch.float8_e4m3fn)
    tattn.write_kv(tpool, k, k, torch.from_numpy(slots),
                   k_scale=torch.tensor(scale), v_scale=torch.tensor(scale))
    got = tpool.float().numpy()
    assert np.isnan(jpool[0, :2]).all()
    np.testing.assert_array_equal(got[0, 0], 448.0)
    np.testing.assert_array_equal(got[0, 1], -448.0)
    np.testing.assert_array_equal(got[0, 2:], jpool[0, 2:])


# --------------------------------------------------------------------- #
# attention on 8-bit pools
# --------------------------------------------------------------------- #
def _setup(seed, q_lens, ctx_lens, qh, kvh, hd, kind, ps=16):
    """Packed q, and a shuffled paged pool of ``kind`` quantized from
    standard normals by SCALES (K and V apart), with its page table."""
    rng = np.random.default_rng(seed)
    S = len(q_lens)
    kv_lens = np.array([c + q for c, q in zip(ctx_lens, q_lens)], np.int32)
    max_pages = int(max((kv_lens.max() + ps - 1) // ps, 1))
    P = S * max_pages + 1
    pool = rng.standard_normal((P, ps, 2 * kvh, hd)).astype(np.float32)
    ks, vs = SCALES[kind]
    pool[:, :, 0::2] /= ks
    pool[:, :, 1::2] /= vs
    if kind == "int8":
        pool8 = np.clip(np.round(pool), -128, 127).astype(np.int8)
    else:
        pool8 = np.clip(pool, -448, 448).astype(ml_dtypes.float8_e4m3fn)
    pt = rng.permutation(S * max_pages).astype(np.int32).reshape(S, -1)
    q = rng.standard_normal((int(np.sum(q_lens)), qh, hd)).astype(np.float32)
    cu = np.zeros(S + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    return q, pool8, kv_lens, pt, cu


def _opts(name, qh):
    if name == "window_softcap":
        return {"sliding_window": 13, "soft_cap": 30.0}
    if name == "sinks":
        return {"sinks": np.linspace(-1.0, 2.0, qh).astype(np.float32)}
    return {}


def _both(opts, kind, dtype):
    """(JAX keyword arguments, port keyword arguments, JAX q dtype, torch
    q dtype): the options and the scales for each package."""
    ks, vs = SCALES[kind]
    jo, to = dict(opts), dict(opts)
    if "sinks" in opts:
        jo["sinks"] = jnp.asarray(opts["sinks"])
        to["sinks"] = torch.from_numpy(opts["sinks"])
    jo.update(k_scale=np.float32(ks), v_scale=np.float32(vs))
    to.update(k_scale=torch.tensor(ks), v_scale=torch.tensor(vs))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return jo, to, jdt, tdt


def _metadata(mod, tensor, kvl, pt, cu, T):
    S = len(kvl)
    return mod.AttentionMetadata(
        kv_lens=tensor(kvl), page_indices=tensor(pt), cu_q_lens=tensor(cu),
        num_seqs=tensor(np.asarray([S], np.int32)),
        slot_mapping=tensor(np.zeros(T, np.int32)),
        positions=tensor(np.zeros(T, np.int32)),
        logits_indices=tensor(np.zeros(S, np.int32)))


def _jax_reference(q, pool8, kvl, pt, cu, jdt, hd, jo):
    """The JAX ``_reference_attention`` (it takes no sinks)."""
    jo = {k: v for k, v in jo.items() if k != "sinks"}
    jo.setdefault("sliding_window", None)
    jo.setdefault("soft_cap", None)
    return jattn._reference_attention(
        jnp.asarray(q).astype(jdt), jnp.asarray(pool8),
        _metadata(jattn, jnp.asarray, kvl, pt, cu, q.shape[0]),
        sm_scale=hd ** -0.5, **jo)


def _check(got: torch.Tensor, want, dtype, live=None):
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    if live is not None:
        got, want = got[live], want[live]
    np.testing.assert_allclose(got, want, **TOLS[dtype])


DECODE_CASES = [
    # (kv_lens, qh, kvh, hd, option set)
    ([7, 30, 1, 19], 4, 2, 64, None),
    ([61, 5, 29], 8, 2, 64, "window_softcap"),
    ([17, 44, 3], 8, 2, 64, "sinks"),
    ([40, 9], 4, 2, 256, "window_softcap"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(SCALES))
@pytest.mark.parametrize("kv_lens,qh,kvh,hd,opt", DECODE_CASES)
def test_decode_plain_on_8bit_pool_matches_jax(kv_lens, qh, kvh, hd, opt,
                                               kind, dtype):
    S = len(kv_lens)
    q, pool8, kvl, pt, cu = _setup(21, [1] * S, [k - 1 for k in kv_lens],
                                   qh, kvh, hd, kind)
    jo, to, jdt, tdt = _both(_opts(opt, qh), kind, dtype)
    got = paged_decode_attention_plain(
        torch.from_numpy(q).to(tdt), _np_to_torch(pool8),
        torch.from_numpy(kvl), torch.from_numpy(pt), sm_scale=hd ** -0.5,
        **to)
    pallas = jax_decode(jnp.asarray(q).astype(jdt), jnp.asarray(pool8),
                        jnp.asarray(kvl), jnp.asarray(pt),
                        sm_scale=hd ** -0.5, interpret=True, **jo)
    _check(got, pallas, dtype)
    if opt != "sinks":
        _check(got, _jax_reference(q, pool8, kvl, pt, cu, jdt, hd, jo),
               dtype)


PREFILL_CASES = [
    # (q_lens, ctx_lens, qh, kvh, hd, option set)
    ([7, 30, 1], [0, 0, 40], 8, 4, 64, None),
    ([25, 9], [10, 30], 8, 2, 64, "window_softcap"),
    ([9, 21, 1], [4, 0, 30], 8, 2, 64, "sinks"),
    ([20, 1], [10, 30], 4, 2, 256, "window_softcap"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(SCALES))
@pytest.mark.parametrize("q_lens,ctx_lens,qh,kvh,hd,opt", PREFILL_CASES)
def test_prefill_plain_on_8bit_pool_matches_jax(q_lens, ctx_lens, qh, kvh,
                                                hd, opt, kind, dtype):
    q, pool8, kvl, pt, cu = _setup(22, q_lens, ctx_lens, qh, kvh, hd, kind)
    jo, to, jdt, tdt = _both(_opts(opt, qh), kind, dtype)
    got = ragged_prefill_attention_plain(
        torch.from_numpy(q).to(tdt), _np_to_torch(pool8),
        torch.from_numpy(kvl), torch.from_numpy(pt), torch.from_numpy(cu),
        sm_scale=hd ** -0.5, **to)
    pallas = jax_prefill(jnp.asarray(q).astype(jdt), jnp.asarray(pool8),
                         jnp.asarray(kvl), jnp.asarray(pt), jnp.asarray(cu),
                         sm_scale=hd ** -0.5, max_q_len=64, interpret=True,
                         **jo)
    _check(got, pallas, dtype)
    if opt != "sinks":
        _check(got, _jax_reference(q, pool8, kvl, pt, cu, jdt, hd, jo),
               dtype)


@pytest.mark.parametrize("kind", list(SCALES))
@pytest.mark.parametrize("q_lens,ctx_lens", [
    ([1, 12, 1, 5], [20, 0, 33, 7]),       # mixed: the prefill kernel
    ([1, 1, 1], [20, 0, 33]),              # decode-only: the decode kernel
])
def test_dispatch_and_reference_on_8bit_pool_match_jax(q_lens, ctx_lens,
                                                       kind):
    """The port's ``ragged_paged_attention`` and ``_reference_attention``
    against the JAX ``_reference_attention``, float32."""
    q, pool8, kvl, pt, cu = _setup(23, q_lens, ctx_lens, 8, 2, 64, kind)
    jo, to, jdt, tdt = _both({}, kind, "float32")
    want = _jax_reference(q, pool8, kvl, pt, cu, jdt, 64, jo)
    md = _metadata(tattn, torch.from_numpy, kvl, pt, cu, q.shape[0])
    args = (torch.from_numpy(q), _np_to_torch(pool8), md)
    _check(tattn.ragged_paged_attention(*args, sm_scale=0.125, **to), want,
           "float32")
    _check(tattn._reference_attention(*args, sm_scale=0.125, **to), want,
           "float32")


# --------------------------------------------------------------------- #
# the model forward on an 8-bit pool
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("algo", ["INT8", "FP8", "NVFP4"])
def test_forward_on_8bit_pool_matches_jax(algo):
    """tinycode-llama's forward in float32 on a quantized pool, a prefill
    step of two prompts then a decode step, each layer at its own scale
    (set in the JAX tree, carried by ``from_jax_params(kv_scales=True)``):
    logits within 1e-4, and the pools' bytes equal but for values whose
    float32 K/V (summed in another order by the two forwards) straddle a
    rounding point: those differ by one code, in under 1e-4 of the
    entries (no value leaves the range: the scales are stated large
    enough)."""
    import jax
    from transformers import AutoConfig

    from tensorrt_llm_tpu.llmapi.llm_args import QuantConfig as JQc
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu.quantization.lazy_state_dict import LazyStateDict
    from tensorrt_llm_tpu.quantization.mode import KvCacheQuantAlgo as JK
    from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
    from tensorrt_llm_tpu_torch.models import ModelConfig as TConfig
    from tensorrt_llm_tpu_torch.models import from_jax_params
    from tensorrt_llm_tpu_torch.models import get_model_class as tget
    from tensorrt_llm_tpu_torch.quantization.mode import KvCacheQuantAlgo
    cfg = AutoConfig.from_pretrained(CKPT)
    jm = jget("llama")(JConfig(hf_config=cfg, dtype=jnp.float32,
                               quant_config=JQc(kv_cache_quant_algo=JK[algo])))
    tm = tget("llama")(TConfig(hf_config=cfg, dtype=torch.float32,
                               device="cpu", quant_config=QuantConfig(
                                   kv_cache_quant_algo=KvCacheQuantAlgo[algo])))
    jparams = jm.load_hf_state_dict(LazyStateDict(CKPT))
    L = jm.num_layers
    # the absmax of these prompts' K/V stays below ~30 (the LLM tests):
    # int8 at 0.25 tops out at 31.75, e4m3 at 0.1 at 44.8, the fp4 grid at
    # 5.5 at 33
    base = {"INT8": 0.25, "FP8": 0.1, "NVFP4": 5.5}[algo]
    jparams["layers"]["kv_scale"] = jnp.asarray(
        base * (1 + 0.1 * np.arange(L)), jnp.float32)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams),
                              kv_scales=True)
    if algo == "NVFP4":          # the engine's stamp (model_engine.py)
        import dataclasses
        jm.attn_spec = dataclasses.replace(jm.attn_spec, kv_fp4=True)
        tm.attn_spec = dataclasses.replace(tm.attn_spec, kv_fp4=True)
    np.testing.assert_array_equal(
        [float(layer["kv_scale"]) for layer in tparams["layers"]],
        np.asarray(jparams["layers"]["kv_scale"]))
    ps, pages_n = 16, 8
    rng = np.random.default_rng(0)
    lens = [11, 23]
    pages = np.array([[0, 1] + [0] * 6, [2, 3] + [0] * 6], np.int32)
    toks = rng.integers(0, 256, size=sum(lens)).astype(np.int32)
    pos = np.concatenate([np.arange(n) for n in lens]).astype(np.int32)
    seq = np.repeat([0, 1], lens)
    slots = (pages[seq, pos // ps] * ps + pos % ps).astype(np.int32)
    cu = np.array([0, 11, 34], np.int32)

    def md(mod, tensor, kv_lens, cu, slots, pos, logits_idx):
        return mod.AttentionMetadata(
            kv_lens=tensor(np.asarray(kv_lens, np.int32)),
            page_indices=tensor(pages), cu_q_lens=tensor(cu),
            num_seqs=tensor(np.asarray([2], np.int32)),
            slot_mapping=tensor(slots), positions=tensor(pos),
            logits_indices=tensor(np.asarray(logits_idx, np.int32)))
    jpool = jm.make_kv_pages(pages_n, ps)
    tpool = tm.make_kv_pages(pages_n, ps)
    assert tpool.dtype == {"INT8": torch.int8}.get(algo, torch.float8_e4m3fn)
    t = torch.from_numpy
    jl, jpool = jm.forward(jparams, jnp.asarray(toks), jpool, md(
        jattn, jnp.asarray, lens, cu, slots, pos, [10, 33]))
    tl, tpool = tm.forward(tparams, t(toks).long(), tpool, md(
        tattn, t, lens, cu, slots, pos, [10, 33]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    tb, jb = _codes(tpool), _codes(jpool)
    assert (tb != jb).mean() < 1e-4
    assert np.abs(tb - jb).max() <= 1
    nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)
    dpos = np.array(lens, np.int32)
    dslots = (pages[[0, 1], dpos // ps] * ps + dpos % ps).astype(np.int32)
    dcu = np.array([0, 1, 2], np.int32)
    kv = [n + 1 for n in lens]
    jl2, _ = jm.forward(jparams, jnp.asarray(nxt), jpool, md(
        jattn, jnp.asarray, kv, dcu, dslots, dpos, [0, 1]))
    tl2, _ = tm.forward(tparams, t(nxt).long(), tpool, md(
        tattn, t, kv, dcu, dslots, dpos, [0, 1]))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=1e-4)


# --------------------------------------------------------------------- #
# ModelConfig and pool sizing
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("algo,dtype,scale,grid", [
    ("NO_QUANT", torch.float32, 1.0, False),
    ("INT8", torch.int8, 0.05, False),
    ("FP8", torch.float8_e4m3fn, 1.0, False),
    ("NVFP4", torch.float8_e4m3fn, 1 / 6, True),
])
def test_model_config_kv_cache_matches_jax(algo, dtype, scale, grid):
    from tensorrt_llm_tpu.models.modeling_utils import ModelConfig as JCfg
    from tensorrt_llm_tpu.quantization.mode import KvCacheQuantAlgo as JK
    from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
    from tensorrt_llm_tpu_torch.models import ModelConfig
    from tensorrt_llm_tpu_torch.quantization.mode import KvCacheQuantAlgo
    from tensorrt_llm_tpu.llmapi.llm_args import QuantConfig as JQc
    cfg = ModelConfig(hf_config=None, dtype=torch.float32, device="cpu",
                      quant_config=QuantConfig(
                          kv_cache_quant_algo=KvCacheQuantAlgo[algo]))
    jcfg = JCfg(hf_config=None, dtype=jnp.float32,
                quant_config=JQc(kv_cache_quant_algo=JK[algo]))
    assert cfg.kv_cache_dtype == dtype
    assert cfg.kv_scale == pytest.approx(scale) == jcfg.kv_scale
    assert cfg.kv_fp4_grid == grid == jcfg.kv_fp4_grid
    assert cfg.uses_kv_quant == jcfg.uses_kv_quant == (algo != "NO_QUANT")


def test_an_8bit_pool_holds_twice_the_pages():
    """The CPU's fixed pool budget holds twice the pages at one byte an
    element: bf16 model, FP8 pool."""
    from transformers import LlamaConfig

    from tensorrt_llm_tpu_torch.llmapi.llm_args import LlmArgs, QuantConfig
    from tensorrt_llm_tpu_torch.models import ModelConfig, get_model_class
    from tensorrt_llm_tpu_torch.quantization.mode import KvCacheQuantAlgo
    from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine
    hf = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=1 << 20)
    pages = {}
    for algo in ("NO_QUANT", "FP8"):
        args = LlmArgs(model="x", load_format="dummy", max_batch_size=64,
                       max_input_len=1 << 19, quant_config=QuantConfig(
                           kv_cache_quant_algo=KvCacheQuantAlgo[algo]))
        model = get_model_class("llama")(ModelConfig(
            hf_config=hf, dtype=torch.bfloat16, device="cpu",
            quant_config=args.quant_config))
        eng = ModelEngine.__new__(ModelEngine)
        eng.model, eng.args, eng.device = model, args, torch.device("cpu")
        eng.page_size = 32
        eng.max_batch_size = 64
        eng.pages_per_seq = -(-args.max_seq_len // 32)
        eng._vswa, eng.num_sw_pages = False, 0
        pages[algo] = (eng._default_num_pages(), eng.bytes_per_kv_block)
    assert pages["FP8"][1] * 2 == pages["NO_QUANT"][1]
    assert pages["FP8"][0] == 2 * pages["NO_QUANT"][0] == 2 * (2 << 30) \
        // pages["NO_QUANT"][1]


# --------------------------------------------------------------------- #
# Refusals
# --------------------------------------------------------------------- #
def test_unknown_kv_algorithm_refused_by_name():
    from pydantic import ValidationError

    from tensorrt_llm_tpu_torch.llmapi.llm_args import QuantConfig
    with pytest.raises(ValidationError, match="kv_cache_quant_algo"):
        QuantConfig(kv_cache_quant_algo="FP4_E2M1")


def test_modelopt_container_refused_by_name(tmp_path):
    from tensorrt_llm_tpu_torch import LLM
    for f in ("config.json", "model.safetensors"):
        (tmp_path / f).symlink_to(CKPT / f)
    (tmp_path / "hf_quant_config.json").write_text(json.dumps(
        {"quantization": {"quant_algo": "FP8",
                          "kv_cache_quant_algo": "FP8"}}))
    with pytest.raises(NotImplementedError, match="ModelOpt"):
        LLM(str(tmp_path), device="cpu", skip_tokenizer_init=True)
