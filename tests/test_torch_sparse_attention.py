"""Top-k page-sparse decode attention of the port
(tensorrt_llm_tpu_torch/ops/sparse_attention.py) against the JAX
function (tensorrt_llm_tpu/ops/sparse_attention.py): the plain version,
the compacted-table route through the decode kernel's plain version, the
card indexer's chunks, the selection's ties and DSA's projection."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.ops import sparse_attention as jsa
from tensorrt_llm_tpu.ops.attention import AttentionMetadata
from tensorrt_llm_tpu_torch.ops import sparse_attention as tsa
from tensorrt_llm_tpu_torch.ops.attention import quantize_kv

ALGOS = ("ROCKET_TOPK", "DSA")


def _jax_md(kv_lens, page_indices):
    S = len(kv_lens)
    return AttentionMetadata(
        kv_lens=jnp.asarray(kv_lens, jnp.int32),
        page_indices=jnp.asarray(page_indices, jnp.int32),
        cu_q_lens=jnp.arange(S + 1, dtype=jnp.int32),
        num_seqs=jnp.full((1,), S, jnp.int32),
        slot_mapping=jnp.full((S,), 10 ** 6, jnp.int32),
        positions=jnp.asarray(kv_lens, jnp.int32) - 1,
        logits_indices=jnp.arange(S, dtype=jnp.int32))


def _setup(pool="float32", S=3, P=8, ps=16, kvh=2, qh=4, hd=32, seed=0):
    """A pool of S * P shuffled pages (+ 1 spare), float32 queries, and
    lengths: a full table, a partly filled tail, a short sequence."""
    r = np.random.default_rng(seed)
    kv = r.standard_normal((S * P + 1, ps, 2 * kvh, hd)).astype(np.float32)
    q = r.standard_normal((S, qh, hd)).astype(np.float32)
    table = r.permutation(S * P).reshape(S, P).astype(np.int32)
    kv_lens = [P * ps, 5 * ps + 7, ps + 1][:S]
    scale = None
    kv_t = torch.from_numpy(kv)
    if pool == "int8":
        scale = 0.05
        kv_t = quantize_kv(kv_t, scale, torch.int8)
    elif pool == "e4m3":
        scale = 0.02
        kv_t = quantize_kv(kv_t, scale, torch.float8_e4m3fn)
    if pool == "e4m3":
        kv_j = jax.lax.bitcast_convert_type(
            jnp.asarray(kv_t.view(torch.uint8).numpy()), jnp.float8_e4m3fn)
    else:
        kv_j = jnp.asarray(kv_t.numpy())
    return q, kv_t, kv_j, kv_lens, table, ps, hd, scale


def _jax(q, kv_j, kv_lens, table, hd, keep, algo, cap, scale):
    return np.asarray(jsa.sparse_paged_decode_attention(
        jnp.asarray(q), kv_j, _jax_md(kv_lens, table), sm_scale=hd ** -0.5,
        keep_pages=keep, algo=algo, soft_cap=cap, k_scale=scale,
        v_scale=scale))


CASES = [(algo, keep, pool, cap)
         for algo in ALGOS for keep in (1, 2, 3, 8, 11)
         for pool, cap in (("float32", None), ("float32", 5.0),
                           ("int8", None), ("e4m3", None))
         if pool == "float32" or keep in (3, 8)]


@pytest.mark.parametrize("algo,keep,pool,cap", CASES)
def test_plain_and_route_match_jax(algo, keep, pool, cap):
    """The plain version and the compacted route (the decode kernel's
    plain version on the selected pages) against the JAX function, float32
    to 1e-5: keep_pages 1, 2, 3, P (8) and > P, a partly filled tail,
    a soft cap, int8 and e4m3 pools."""
    q, kv_t, kv_j, kv_lens, table, ps, hd, scale = _setup(pool)
    ref = _jax(q, kv_j, kv_lens, table, hd, keep, algo, cap, scale)
    args = (torch.from_numpy(q), kv_t, torch.tensor(kv_lens),
            torch.from_numpy(table))
    kw = dict(sm_scale=hd ** -0.5, keep_pages=keep, algo=algo, soft_cap=cap,
              k_scale=scale, v_scale=scale)
    plain = tsa.sparse_paged_decode_attention_plain(*args, **kw)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=1e-5, atol=1e-5)
    route = tsa.sparse_paged_decode_attention(*args, max_kv_len=8 * ps,
                                              **kw)
    np.testing.assert_allclose(route.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("algo", ALGOS)
def test_route_bound_and_chunks(algo, monkeypatch):
    """The route reads the table only up to the step's KV bound and in
    chunks of pages: a one-page chunk and a bound below the table's reach
    give the JAX function's output."""
    q, kv_t, kv_j, kv_lens, table, ps, hd, _ = _setup(S=3)
    ref = _jax(q, kv_j, kv_lens, table, hd, 3, algo, None, None)
    monkeypatch.setattr(tsa, "INDEXER_CHUNK_BYTES", 1)
    got = tsa.sparse_paged_decode_attention(
        torch.from_numpy(q), kv_t, torch.tensor(kv_lens),
        torch.from_numpy(table), sm_scale=hd ** -0.5, keep_pages=3,
        algo=algo, max_kv_len=max(kv_lens))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("keep", (1, 2, 3))
def test_bound_below_the_length_keeps_the_tail(algo, keep):
    """A KV bound below a sequence's length (40 positions: 3 pages of 16,
    against lengths 128 and 87) still keeps that sequence's tail page:
    the route equals the JAX function on the table cut to the bound's 3
    pages with the tail page as the third and the length shortened
    alike; a sequence within the bound is unchanged."""
    q, kv_t, kv_j, kv_lens, table, ps, hd, _ = _setup(S=3)
    reach = 3
    cut, lens = table[:, :reach].copy(), list(kv_lens)
    for i, L in enumerate(kv_lens):
        tail = -(-L // ps) - 1
        if tail >= reach:
            cut[i, -1] = table[i, tail]
            lens[i] = (reach - 1) * ps + L - tail * ps
    assert lens == [48, 39, 17]
    ref = _jax(q, kv_j, lens, cut, hd, keep, algo, None, None)
    got = tsa.sparse_paged_decode_attention(
        torch.from_numpy(q), kv_t, torch.tensor(kv_lens),
        torch.from_numpy(table), sm_scale=hd ** -0.5, keep_pages=keep,
        algo=algo, max_kv_len=40)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_indexer_scores_match_jax():
    """The card indexer's chunked page scores equal the JAX page means'
    and DSA's scores on the live pages."""
    q, kv_t, kv_j, kv_lens, table, ps, hd, _ = _setup()
    used = [-(-n // ps) for n in kv_lens]
    mk = np.asarray(jsa.page_mean_keys(kv_j, jnp.asarray(kv_lens),
                                       jnp.asarray(table), ps))
    qg = q.reshape(3, 2, 2, hd)
    rocket = np.einsum("skgd,spkd->skgp", qg, mk).max(axis=(1, 2))
    dsa = np.asarray(jsa.dsa_page_scores(jnp.asarray(q), kv_j,
                                         jnp.asarray(kv_lens),
                                         jnp.asarray(table), ps))
    args = (torch.from_numpy(q), kv_t, torch.tensor(kv_lens),
            torch.from_numpy(table))
    for algo, ref in (("ROCKET_TOPK", rocket), ("DSA", dsa)):
        got = tsa.page_scores(*args, algo=algo).numpy()
        for s, u in enumerate(used):
            np.testing.assert_allclose(got[s, :u], ref[s, :u], rtol=1e-5,
                                       atol=1e-5)
    np.testing.assert_allclose(
        tsa.page_mean_keys(kv_t, torch.tensor(kv_lens),
                           torch.from_numpy(table), ps).numpy(), mk,
        rtol=1e-6, atol=1e-6)


def test_ties_break_toward_the_lower_ordinal():
    """As ``jax.lax.top_k``: page 0 and the tail both score float32.max,
    so keep_pages 1 keeps page 0; equal scores keep the lower ordinals."""
    score = torch.zeros(2, 6)
    kv_lens = torch.tensor([6 * 4, 3 * 4 + 1])
    sel, live = tsa.select_pages(score, kv_lens, 4, 1)
    assert sel.tolist() == [[0], [0]]
    sel, live = tsa.select_pages(score, kv_lens, 4, 3)
    assert sel.tolist() == [[0, 1, 5], [0, 1, 3]]
    sel, live = tsa.select_pages(score, kv_lens, 4, 6)
    assert live.tolist() == [[True] * 6, [True] * 4 + [False] * 2]
    # the compacted lengths: full pages, less the kept tail's empty slots
    table = torch.arange(12).reshape(2, 6)
    ct, cl = tsa.compact_pages(table, kv_lens,
                               *tsa.select_pages(score, kv_lens, 4, 3), 4)
    assert cl.tolist() == [12, 9] and ct.tolist() == [[0, 1, 5], [6, 7, 9]]
    ct, cl = tsa.compact_pages(table, kv_lens,
                               *tsa.select_pages(score, kv_lens, 4, 1), 4)
    assert cl.tolist() == [4, 4]


@pytest.mark.parametrize("hd", (48, 64, 80, 96, 128, 256))
def test_dsa_projection_matches_jax(hd):
    """DSA's fixed projection, rebuilt without JAX, against
    ``jax.random.normal(PRNGKey(17), (hd, 32)) / sqrt(hd)`` to 1e-6."""
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(17), (hd, 32),
                                       jnp.float32) / (hd ** 0.5))
    np.testing.assert_allclose(tsa.dsa_projection(hd), ref, rtol=0,
                               atol=1e-6)


def test_unknown_algo_refused():
    q, kv_t, _, kv_lens, table, ps, hd, _ = _setup()
    with pytest.raises(ValueError, match="STAR"):
        tsa.sparse_paged_decode_attention(
            torch.from_numpy(q), kv_t, torch.tensor(kv_lens),
            torch.from_numpy(table), sm_scale=1.0, keep_pages=2,
            algo="STAR")


@pytest.mark.parametrize("pool", ("float32", "int8"))
def test_layer_pool_sums_match_the_chunks(pool):
    """ROCKET_TOPK's one-pass sum over the layer's part of the pool
    (``pool_pages``) scores the pages as the chunked gather does, and the
    route then matches the JAX function."""
    q, kv_t, kv_j, kv_lens, table, ps, hd, scale = _setup(pool)
    args = (torch.from_numpy(q), kv_t, torch.tensor(kv_lens),
            torch.from_numpy(table))
    whole = (0, kv_t.shape[0])
    np.testing.assert_allclose(
        tsa.page_scores(*args, algo="ROCKET_TOPK", k_scale=scale,
                        pool_pages=whole).numpy(),
        tsa.page_scores(*args, algo="ROCKET_TOPK", k_scale=scale).numpy(),
        rtol=1e-5, atol=1e-5)
    ref = _jax(q, kv_j, kv_lens, table, hd, 3, "ROCKET_TOPK", None, scale)
    got = tsa.sparse_paged_decode_attention(
        *args, sm_scale=hd ** -0.5, keep_pages=3, k_scale=scale,
        v_scale=scale, pool_pages=whole)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
