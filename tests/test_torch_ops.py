"""Parity of the PyTorch port's ops with the JAX package's ops on the CPU:
norm, RoPE, KV append, per-layer metadata, the dense reference attention
and sampling. Inputs come from numpy with fixed seeds and go through both
implementations in float32."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from tensorrt_llm_tpu.ops import attention as jattn
from tensorrt_llm_tpu.ops import norm as jnorm
from tensorrt_llm_tpu.ops import rope as jrope
from tensorrt_llm_tpu.ops import sampling_ops as jsamp
from tensorrt_llm_tpu_torch.ops import attention as tattn
from tensorrt_llm_tpu_torch.ops import norm as tnorm
from tensorrt_llm_tpu_torch.ops import rope as trope
from tensorrt_llm_tpu_torch.ops import sampling_ops as tsamp

ATOL = 1e-5   # float32 elementwise math; sums in another order


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 48)).astype(np.float32)
    r = rng.standard_normal((7, 48)).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    ref = jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = tnorm.rms_norm(_t(x), _t(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    ref_n, ref_r = jnorm.rms_norm_residual(jnp.asarray(x), jnp.asarray(r),
                                           jnp.asarray(w), 1e-5)
    got_n, got_r = tnorm.rms_norm_residual(_t(x), _t(r), _t(w), 1e-5)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(ref_n), atol=ATOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(ref_r), atol=ATOL)


@pytest.mark.parametrize("scaling,is_neox", [
    (None, True),
    ({"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
      "high_freq_factor": 4.0, "original_max_position_embeddings": 64},
     True),
    ({"type": "linear", "factor": 2.0}, False),
    ({"rope_type": "yarn", "factor": 4.0,
      "original_max_position_embeddings": 64}, True),
])
def test_rope_matches_jax(scaling, is_neox):
    from transformers import LlamaConfig
    cfg = LlamaConfig(hidden_size=256, num_attention_heads=4,
                      rope_theta=10000.0, max_position_embeddings=512,
                      rope_scaling=scaling)
    jcfg = jrope.RopeConfig.from_hf_config(cfg, 64)
    tcfg = trope.RopeConfig.from_hf_config(cfg, 64)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 500, size=11).astype(np.int32)
    x = rng.standard_normal((11, 3, 64)).astype(np.float32)
    jc, js = jrope.rope_cos_sin(jcfg, jnp.asarray(pos))
    tc, ts = trope.rope_cos_sin(tcfg, _t(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL)
    ref = jrope.apply_rope(jnp.asarray(x), jc, js, is_neox)
    got = trope.apply_rope(_t(x), tc, ts, is_neox)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_write_kv_matches_jax_and_drops_out_of_range():
    rng = np.random.default_rng(2)
    P, ps, kvh, hd, T = 5, 4, 2, 8, 9
    pool = rng.standard_normal((P, ps, 2 * kvh, hd)).astype(np.float32)
    k = rng.standard_normal((T, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((T, kvh, hd)).astype(np.float32)
    slots = np.array([3, 17, P * ps, 0, 19, P * ps + 7, 8, 9, 2], np.int32)
    ref = jattn.write_kv(jnp.asarray(pool), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(slots))
    got = tattn.write_kv(_t(pool.copy()), _t(k), _t(v), _t(slots))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # every slot dropped: the pool is unchanged
    none = np.full(T, P * ps, np.int32)
    got = tattn.write_kv(_t(pool.copy()), _t(k), _t(v), _t(none))
    np.testing.assert_array_equal(got.numpy(), pool)


def _metadata(mod, tensor, kv_lens, cu, pages, slots):
    S = len(kv_lens)
    return mod.AttentionMetadata(
        kv_lens=tensor(np.asarray(kv_lens, np.int32)),
        page_indices=tensor(np.asarray(pages, np.int32)),
        cu_q_lens=tensor(np.asarray(cu, np.int32)),
        num_seqs=tensor(np.asarray([S], np.int32)),
        slot_mapping=tensor(np.asarray(slots, np.int32)),
        positions=tensor(np.zeros(len(slots), np.int32)),
        logits_indices=tensor(np.zeros(S, np.int32)))


def test_layer_metadata_matches_jax():
    P, ps, L = 6, 4, 3
    slots = [0, 5, 23, P * ps, P * ps + 3]
    pages = [[0, 1, 2], [3, 4, 5]]
    jm = _metadata(jattn, jnp.asarray, [5, 7], [0, 2, 5], pages, slots)
    tm = _metadata(tattn, _t, [5, 7], [0, 2, 5], pages, slots)
    for layer in range(L):
        ref = jattn.layer_metadata(jm, layer, P, ps, L)
        got = tattn.layer_metadata(tm, layer, P, ps, L)
        np.testing.assert_array_equal(got.slot_mapping.numpy(),
                                      np.asarray(ref.slot_mapping))
        np.testing.assert_array_equal(got.page_indices.numpy(),
                                      np.asarray(ref.page_indices))


@pytest.mark.parametrize("opts", [
    {},
    {"sliding_window": 5, "soft_cap": 20.0},
    {"alibi_slopes": (0.5, 0.25, 0.125, 0.0625)},
    {"sinks": np.linspace(-1.0, 1.0, 4).astype(np.float32)},
])
def test_reference_attention_matches_jax(opts):
    rng = np.random.default_rng(3)
    ps, kvh, qh, hd = 4, 2, 4, 16
    q_lens, ctx = [3, 1, 6], [2, 9, 0]
    kv_lens = [c + q for c, q in zip(ctx, q_lens)]
    cu = np.concatenate([[0], np.cumsum(q_lens)])
    pages = np.arange(9).reshape(3, 3)
    pool = rng.standard_normal((10, ps, 2 * kvh, hd)).astype(np.float32)
    q = rng.standard_normal((int(cu[-1]), qh, hd)).astype(np.float32)
    slots = np.zeros(int(cu[-1]), np.int32)
    jm = _metadata(jattn, jnp.asarray, kv_lens, cu, pages, slots)
    tm = _metadata(tattn, _t, kv_lens, cu, pages, slots)
    jopts = dict(opts)
    topts = dict(opts)
    if "sinks" in opts:
        jopts["sinks"] = jnp.asarray(opts["sinks"])
        topts["sinks"] = _t(opts["sinks"])
    jopts.setdefault("sliding_window", None)
    jopts.setdefault("soft_cap", None)
    ref = jattn._reference_attention(jnp.asarray(q), jnp.asarray(pool), jm,
                                     sm_scale=0.25, k_scale=None,
                                     v_scale=None, **jopts)
    got = tattn._reference_attention(_t(q), _t(pool), tm, sm_scale=0.25,
                                     **topts)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


# --------------------------------------------------------------------- #
# Sampling
# --------------------------------------------------------------------- #
def _st(mod, tensor, B, temperature=1.0, top_k=0, top_p=1.0, min_p=0.0,
        greedy=False):
    f = np.full(B, 1.0, np.float32)
    return mod.SamplingTensors(
        temperature=tensor(np.full(B, temperature, np.float32)),
        top_k=tensor(np.full(B, top_k, np.int32 if mod is jsamp
                             else np.int64)),
        top_p=tensor(np.full(B, top_p, np.float32)),
        min_p=tensor(np.full(B, min_p, np.float32)),
        greedy=tensor(np.full(B, greedy)),
        repetition_penalty=tensor(f * 1.3),
        presence_penalty=tensor(f * 0.5),
        frequency_penalty=tensor(f * 0.2))


def test_mask_logits_and_penalties_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((6, 40)).astype(np.float32) * 3
    counts = rng.integers(0, 3, size=(6, 40)).astype(np.int32)
    for kw in ({"top_k": 5}, {"top_p": 0.7, "temperature": 0.6},
               {"min_p": 0.1, "temperature": 1.5}):
        js = _st(jsamp, jnp.asarray, 6, **kw)
        ts = _st(tsamp, _t, 6, **kw)
        ref = jsamp.mask_logits(jnp.asarray(logits), js)
        got = tsamp.mask_logits(_t(logits), ts)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    ref = jsamp.apply_penalties(jnp.asarray(logits), jnp.asarray(counts), js)
    got = tsamp.apply_penalties(_t(logits), _t(counts), ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_greedy_sample_bit_exact():
    import jax
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((9, 50)).astype(np.float32)
    js = _st(jsamp, jnp.asarray, 9, greedy=True)
    ts = _st(tsamp, _t, 9, greedy=True)
    jt, jl = jsamp.sample(jnp.asarray(logits), js, jax.random.PRNGKey(0))
    tt, tl = tsamp.sample(_t(logits), ts, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    gt, gl = tsamp.greedy_sample(_t(logits))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jt))
    # greedy rows report the processed-distribution logprob (temperature
    # 1, nothing masked): log-softmax at the argmax
    np.testing.assert_allclose(gl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


@pytest.mark.parametrize("kw", [
    {"top_k": 5, "temperature": 0.8},
    {"top_p": 0.8, "temperature": 1.2},
])
def test_sampled_draws_match_jax_distribution(kw):
    """2,000 draws from one logits row through each sampler; both counts
    must fit the processed distribution (chi-square, p > 0.001) — the
    random bits differ by design."""
    import jax
    N, V = 2000, 12
    row = np.linspace(-2.0, 2.0, V).astype(np.float32)
    logits = np.tile(row, (N, 1))
    js = _st(jsamp, jnp.asarray, N, **kw)
    ts = _st(tsamp, _t, N, **kw)
    probs = torch.softmax(tsamp.mask_logits(_t(logits[:1]), _st(
        tsamp, _t, 1, **kw)), -1)[0].numpy().astype(np.float64)
    support = probs > 0
    jt, _ = jsamp.sample(jnp.asarray(logits), js, jax.random.PRNGKey(7))
    tt, _ = tsamp.sample(_t(logits), ts, torch.Generator().manual_seed(7))
    for toks in (np.asarray(jt), tt.numpy()):
        counts = np.bincount(toks, minlength=V)
        assert counts[~support].sum() == 0
        p = probs[support] / probs[support].sum()
        chi = stats.chisquare(counts[support], p * N)
        assert chi.pvalue > 1e-3, (counts, probs)


def test_seeded_rows_are_position_keyed():
    """A seeded row's draw depends on (seed, position) only: the same
    pair gives the same token in any row, and draws over many positions
    follow the distribution."""
    N, V = 2000, 12
    row = np.linspace(-2.0, 2.0, V).astype(np.float32)
    logits = _t(np.tile(row, (N, 1)))
    ts = _st(tsamp, _t, N, temperature=1.0)
    seeds = torch.full((N,), 1234, dtype=torch.int32)
    pos = torch.arange(N, dtype=torch.int32)
    a, _ = tsamp.sample(logits, ts, torch.Generator().manual_seed(1),
                        row_seeds=(seeds, pos))
    b, _ = tsamp.sample(logits.flip(0), ts, torch.Generator().manual_seed(2),
                        row_seeds=(seeds, pos.flip(0)))
    np.testing.assert_array_equal(a.numpy(), b.flip(0).numpy())
    probs = torch.softmax(_t(row), -1).numpy().astype(np.float64)
    probs /= probs.sum()
    chi = stats.chisquare(np.bincount(a.numpy(), minlength=V), probs * N)
    assert chi.pvalue > 1e-3
