"""The port's paged attention against the JAX package: the plain PyTorch
versions of the decode and prefill kernels against the JAX Pallas kernels
run in interpret mode, and the port's ``ragged_paged_attention`` dispatch
against the JAX dense reference. float32 throughout; tolerance 2e-5 (the
softmax sums are taken in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.models.modeling_utils import alibi_slopes
from tensorrt_llm_tpu.ops import attention as jattn
from tensorrt_llm_tpu.ops.pallas.decode_attention import \
    paged_decode_attention as jax_decode
from tensorrt_llm_tpu.ops.pallas.prefill_attention import \
    ragged_prefill_attention as jax_prefill
from tensorrt_llm_tpu_torch.ops import attention as tattn
from tensorrt_llm_tpu_torch.ops.cuda.decode_attention import \
    paged_decode_attention_plain
from tensorrt_llm_tpu_torch.ops.cuda.prefill_attention import \
    ragged_prefill_attention_plain

TOL = dict(rtol=2e-5, atol=2e-5)


def _setup(seed, q_lens, ctx_lens, qh, kvh, hd, ps=16):
    """Packed q + a paged pool where each sequence has ctx_len history and
    q_len new tokens; pages are handed out in a shuffled order so page
    tables are not the identity."""
    rng = np.random.default_rng(seed)
    S = len(q_lens)
    kv_lens = np.array([c + q for c, q in zip(ctx_lens, q_lens)], np.int32)
    max_pages = int(max((kv_lens.max() + ps - 1) // ps, 1))
    P = S * max_pages + 1
    pool = rng.standard_normal((P, ps, 2 * kvh, hd)).astype(np.float32)
    page_indices = rng.permutation(S * max_pages).astype(np.int32) \
        .reshape(S, max_pages)
    q = rng.standard_normal((int(np.sum(q_lens)), qh, hd)).astype(np.float32)
    cu = np.zeros(S + 1, np.int32)
    cu[1:] = np.cumsum(q_lens)
    return q, pool, kv_lens, page_indices, cu


def _opts(name, qh):
    if name == "window_softcap":
        return {"sliding_window": 13, "soft_cap": 30.0}
    if name == "sinks":
        return {"sinks": np.linspace(-1.0, 2.0, qh).astype(np.float32)}
    if name == "alibi":
        return {"alibi_slopes": alibi_slopes(qh)}
    return {}


def _split(opts):
    jo, to = dict(opts), dict(opts)
    if "sinks" in opts:
        jo["sinks"] = jnp.asarray(opts["sinks"])
        to["sinks"] = torch.from_numpy(opts["sinks"])
    return jo, to


T_ = torch.from_numpy

DECODE_CASES = [
    # (kv_lens, qh, kvh, hd, ps, option set)
    ([7, 30, 1, 19], 4, 2, 64, 16, None),          # GQA group 2
    ([150, 33], 8, 1, 128, 16, None),              # group 8, hd 128,
                                                   # crosses 128-pos tiles
    ([12, 40, 0, 0], 8, 2, 64, 8, None),           # padded trailing seqs
    ([61, 5, 29], 8, 2, 64, 16, "window_softcap"),
    ([17, 44, 3], 8, 2, 64, 16, "sinks"),
    ([9, 38, 26], 8, 2, 64, 16, "alibi"),
]


@pytest.mark.parametrize("kv_lens,qh,kvh,hd,ps,opt", DECODE_CASES)
def test_decode_plain_matches_pallas(kv_lens, qh, kvh, hd, ps, opt):
    S = len(kv_lens)
    q, pool, kvl, pt, _ = _setup(11, [1] * S, [k - 1 if k else 0
                                               for k in kv_lens],
                                 qh, kvh, hd, ps)
    kvl = np.asarray(kv_lens, np.int32)
    jo, to = _split(_opts(opt, qh))
    ref = jax_decode(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(kvl),
                     jnp.asarray(pt), sm_scale=hd ** -0.5, interpret=True,
                     **jo)
    got = paged_decode_attention_plain(T_(q), T_(pool), T_(kvl), T_(pt),
                                       sm_scale=hd ** -0.5, **to).numpy()
    # padding rows (kv_len 0) hold junk in the TPU kernel; the port
    # returns zeros there, as its CUDA kernel does
    live = kvl > 0
    np.testing.assert_allclose(got[live], np.asarray(ref)[live], **TOL)
    assert not got[~live].any()


PREFILL_CASES = [
    # (q_lens, ctx_lens, qh, kvh, hd, option set)
    ([7, 30, 1], [0, 0, 40], 8, 4, 64, None),      # pure + chunked + decode
    ([33], [0], 8, 1, 128, None),                  # group 8, hd 128
    ([6, 10, 0], [0, 4, 0], 4, 2, 64, None),       # padded trailing seq
    ([25, 9], [10, 30], 8, 2, 64, "window_softcap"),
    ([9, 21, 1], [4, 0, 30], 8, 2, 64, "sinks"),
    ([9, 21, 1], [4, 0, 30], 8, 2, 64, "alibi"),
]


@pytest.mark.parametrize("q_lens,ctx_lens,qh,kvh,hd,opt", PREFILL_CASES)
def test_prefill_plain_matches_pallas(q_lens, ctx_lens, qh, kvh, hd, opt):
    q, pool, kvl, pt, cu = _setup(12, q_lens, ctx_lens, qh, kvh, hd)
    jo, to = _split(_opts(opt, qh))
    ref = jax_prefill(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(kvl),
                      jnp.asarray(pt), jnp.asarray(cu), sm_scale=hd ** -0.5,
                      max_q_len=64, interpret=True, **jo)
    got = ragged_prefill_attention_plain(T_(q), T_(pool), T_(kvl), T_(pt),
                                         T_(cu), sm_scale=hd ** -0.5, **to)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _metadata(mod, tensor, kvl, pt, cu, T):
    S = len(kvl)
    return mod.AttentionMetadata(
        kv_lens=tensor(kvl), page_indices=tensor(pt), cu_q_lens=tensor(cu),
        num_seqs=tensor(np.asarray([S], np.int32)),
        slot_mapping=tensor(np.zeros(T, np.int32)),
        positions=tensor(np.zeros(T, np.int32)),
        logits_indices=tensor(np.zeros(S, np.int32)))


@pytest.mark.parametrize("q_lens,ctx_lens,qh", [
    ([1, 12, 1, 5], [20, 0, 33, 7], 8),     # mixed: decode rows + prefill
    ([1, 1, 1], [20, 0, 33], 8),            # decode-only: decode kernel
    # a 300-token segment at packed offset 10, GQA group 2: past the TPU
    # prefill kernel's 256-row cap and its 16-row-aligned window
    ([10, 300], [0, 0], 4),
])
def test_dispatch_matches_jax_reference(q_lens, ctx_lens, qh):
    q, pool, kvl, pt, cu = _setup(13, q_lens, ctx_lens, qh, 2, 64)
    T = q.shape[0]
    ref = jattn._reference_attention(
        jnp.asarray(q), jnp.asarray(pool),
        _metadata(jattn, jnp.asarray, kvl, pt, cu, T), sm_scale=0.125,
        sliding_window=None, soft_cap=None, k_scale=None, v_scale=None)
    got = tattn.ragged_paged_attention(
        T_(q), T_(pool), _metadata(tattn, T_, kvl, pt, cu, T),
        sm_scale=0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
