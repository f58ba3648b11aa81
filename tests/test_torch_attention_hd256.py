"""The plain versions of the decode and prefill kernels at head_dim 256
(Gemma 2 and 3) against the JAX Pallas kernels in interpret mode, on the
same numpy-seeded inputs, float32, CPU: 2e-5 on live rows (the softmax
sums are taken in another order), as tests/test_torch_attention_split.py
and tests/test_torch_attention.py hold them at hd 64 and 128. Cases: GQA
groups 1, 2 and 4 (Gemma-2-9B's 16 q heads over 8 KV heads, Gemma-3-1B's
4 over 1), the sliding window with the attention soft cap (Gemma 2's),
forced KV splits of the decode version, sinks, and a prefill batch with
decode rows beside chunks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.ops.pallas.decode_attention import \
    paged_decode_attention as jax_decode
from tensorrt_llm_tpu.ops.pallas.prefill_attention import \
    ragged_prefill_attention as jax_prefill
from tensorrt_llm_tpu_torch.ops.cuda import decode_attention as dec
from tensorrt_llm_tpu_torch.ops.cuda import prefill_attention as pre

HD = 256
TOL = dict(rtol=2e-5, atol=2e-5)
T_ = torch.from_numpy


def _setup(seed, q_lens, ctx_lens, qh, kvh, ps=16):
    rng = np.random.default_rng(seed)
    S = len(q_lens)
    kv_lens = np.array([c + q for c, q in zip(ctx_lens, q_lens)], np.int32)
    max_pages = int(max((kv_lens.max() + ps - 1) // ps, 1))
    pool = rng.standard_normal((S * max_pages + 1, ps, 2 * kvh, HD)) \
        .astype(np.float32)
    pt = rng.permutation(S * max_pages).astype(np.int32).reshape(S, -1)
    q = rng.standard_normal((int(np.sum(q_lens)), qh, HD)).astype(np.float32)
    cu = np.zeros(S + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    return q, pool, kv_lens, pt, cu


def _opts(name, qh):
    if name == "window_softcap":
        return {"sliding_window": 24, "soft_cap": 50.0}
    if name == "sinks":
        return {"sinks": np.linspace(-1.0, 2.0, qh).astype(np.float32)}
    return {}


def _split(opts):
    jo, to = dict(opts), dict(opts)
    if "sinks" in opts:
        jo["sinks"] = jnp.asarray(opts["sinks"])
        to["sinks"] = T_(opts["sinks"])
    return jo, to


@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("kv_lens,qh,kvh,opt", [
    ([7, 90, 1, 0], 2, 2, None),                    # group 1, a padded row
    ([130, 33, 61], 16, 8, "window_softcap"),       # Gemma-2-9B's heads
    ([70, 4, 100], 4, 1, "window_softcap"),         # Gemma-3-1B's heads
    ([44, 17, 3], 4, 2, "sinks"),
])
def test_decode_plain_hd256_matches_pallas(num_splits, kv_lens, qh, kvh,
                                           opt):
    S = len(kv_lens)
    q, pool, _, pt, _ = _setup(31, [1] * S, [max(k - 1, 0) for k in kv_lens],
                               qh, kvh)
    kvl = np.asarray(kv_lens, np.int32)
    jo, to = _split(_opts(opt, qh))
    ref = jax_decode(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(kvl),
                     jnp.asarray(pt), sm_scale=HD ** -0.5, interpret=True,
                     **jo)
    got = dec.paged_decode_attention_plain(
        T_(q), T_(pool), T_(kvl), T_(pt), sm_scale=HD ** -0.5,
        num_splits=num_splits, **to).numpy()
    live = kvl > 0
    np.testing.assert_allclose(got[live], np.asarray(ref)[live], **TOL)
    assert not got[~live].any()


@pytest.mark.parametrize("q_lens,ctx_lens,qh,kvh,opt", [
    ([7, 30, 1], [0, 0, 40], 2, 2, None),           # pure + decode row
    ([25, 9, 1], [10, 30, 50], 16, 8, "window_softcap"),
    ([33, 1], [0, 70], 4, 1, "window_softcap"),
    ([9, 21, 1], [4, 0, 30], 4, 2, "sinks"),
])
def test_prefill_plain_hd256_matches_pallas(q_lens, ctx_lens, qh, kvh, opt):
    q, pool, kvl, pt, cu = _setup(32, q_lens, ctx_lens, qh, kvh)
    jo, to = _split(_opts(opt, qh))
    ref = jax_prefill(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(kvl),
                      jnp.asarray(pt), jnp.asarray(cu), sm_scale=HD ** -0.5,
                      max_q_len=64, interpret=True, **jo)
    got = pre.ragged_prefill_attention_plain(
        T_(q), T_(pool), T_(kvl), T_(pt), T_(cu), sm_scale=HD ** -0.5, **to)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_wrappers_take_hd256_on_the_cpu():
    """The CPU wrappers run the plain versions at hd 256 (the card's
    head-dim check is the kernels' own: tests/test_torch_cuda_kernels.py)."""
    assert HD in dec.HEAD_DIMS
    q, pool, kvl, pt, cu = _setup(33, [5, 1], [3, 20], 4, 2)
    got = pre.ragged_prefill_attention(T_(q), T_(pool), T_(kvl), T_(pt),
                                       T_(cu), sm_scale=0.0625)
    dgot = dec.paged_decode_attention(T_(q[5:]), T_(pool), T_(kvl[1:]),
                                      T_(pt[1:]), sm_scale=0.0625)
    torch.testing.assert_close(dgot, got[5:], rtol=1e-5, atol=1e-5)
