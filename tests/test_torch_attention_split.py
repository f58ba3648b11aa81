"""The split-KV decode algorithm of the port, on the CPU.

(a) ``paged_decode_attention_plain(num_splits=n)`` against the unsplit
plain version: 1e-5 in float32 (the same sums in another order);
(b) the split plain version against the JAX Pallas decode kernel in
interpret mode on the same numpy-seeded inputs: 2e-5 on live rows;
(c) ``choose_splits``, the host rule for the number of splits;
(d) ``AttentionMetadata.max_kv_len`` as the engine fills it: an upper
bound of every row's ``kv_len`` at every step."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.models.modeling_utils import alibi_slopes
from tensorrt_llm_tpu.ops.pallas.decode_attention import \
    paged_decode_attention as jax_decode
from tensorrt_llm_tpu_torch.ops import attention as tattn
from tensorrt_llm_tpu_torch.ops.cuda import decode_attention as dec

T_ = torch.from_numpy


def _setup(seed, kv_lens, qh, kvh, hd, ps):
    rng = np.random.default_rng(seed)
    S = len(kv_lens)
    kvl = np.asarray(kv_lens, np.int32)
    max_pages = int(max((kvl.max() + ps - 1) // ps, 1))
    pool = rng.standard_normal((S * max_pages + 1, ps, 2 * kvh, hd)) \
        .astype(np.float32)
    pt = rng.permutation(S * max_pages).astype(np.int32).reshape(S, max_pages)
    q = rng.standard_normal((S, qh, hd)).astype(np.float32)
    return q, pool, kvl, pt


def _opts(name, qh, window):
    if name == "window_softcap":
        return {"sliding_window": window, "soft_cap": 30.0}
    if name == "sinks":
        return {"sinks": np.linspace(-1.0, 2.0, qh).astype(np.float32)}
    if name == "alibi":
        return {"alibi_slopes": alibi_slopes(qh)}
    return {}


def _torch_opts(opts):
    to = dict(opts)
    if "sinks" in to:
        to["sinks"] = T_(to["sinks"])
    return to


# KV lengths: 0, 1, one shorter than a split (40 < 300 / 3), and long
# rows whose 45-wide window starts past the first split of the whole row
KV_LENS = [0, 1, 40, 300, 161, 290, 33]


@pytest.mark.parametrize("num_splits", [1, 2, 3, 7])
@pytest.mark.parametrize("opt", [None, "window_softcap", "sinks", "alibi"])
def test_split_plain_matches_unsplit(num_splits, opt):
    qh, kvh, hd, ps = 8, 2, 64, 16
    q, pool, kvl, pt = _setup(21, KV_LENS, qh, kvh, hd, ps)
    kw = dict(sm_scale=hd ** -0.5, **_torch_opts(_opts(opt, qh, 45)))
    args = (T_(q), T_(pool), T_(kvl), T_(pt))
    ref = dec.paged_decode_attention_plain(*args, **kw)
    got = dec.paged_decode_attention_plain(*args, num_splits=num_splits, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    assert not got[0].any()                      # kv_len 0: zeros


def test_split_bounds_cover_the_visible_range_once():
    """The splits' [lo, hi) are disjoint, ordered, made of whole tiles,
    and together cover exactly [window start rounded down, kv_len)."""
    kvl = T_(np.asarray(KV_LENS + [1000, 31, 32, 64], np.int64))
    tile = dec.SPLIT_TILE
    for window in (None, 45, 500):
        for splits in (1, 2, 3, 7, 40):
            start = (kvl - window).clamp(min=0) if window \
                else torch.zeros_like(kvl)
            start = start // tile * tile
            at = start.clone()
            for i in range(splits):
                lo, hi = dec._split_bounds(kvl, window, tile, splits, i)
                live = hi > lo
                assert torch.equal(lo[live], at[live])
                assert ((lo - start) % tile == 0).all()
                at = torch.where(live, hi, at)
            assert torch.equal(at, torch.maximum(kvl, start))


@pytest.mark.parametrize("num_splits", [2, 5])
@pytest.mark.parametrize("kv_lens,qh,kvh,hd,ps,opt", [
    ([7, 300, 1, 190], 4, 2, 64, 16, None),
    ([150, 33], 8, 1, 128, 16, None),
    ([120, 40, 0, 0], 8, 2, 64, 8, None),
    ([161, 5, 290], 8, 2, 64, 16, "window_softcap"),
    ([170, 44, 3], 8, 2, 64, 16, "sinks"),
    ([9, 380, 26], 8, 2, 64, 16, "alibi"),
])
def test_split_plain_matches_pallas(num_splits, kv_lens, qh, kvh, hd, ps,
                                    opt):
    q, pool, kvl, pt = _setup(22, kv_lens, qh, kvh, hd, ps)
    opts = _opts(opt, qh, 45)
    jo = dict(opts)
    if "sinks" in jo:
        jo["sinks"] = jnp.asarray(jo["sinks"])
    ref = jax_decode(jnp.asarray(q), jnp.asarray(pool), jnp.asarray(kvl),
                     jnp.asarray(pt), sm_scale=hd ** -0.5, interpret=True,
                     **jo)
    got = dec.paged_decode_attention_plain(
        T_(q), T_(pool), T_(kvl), T_(pt), sm_scale=hd ** -0.5,
        num_splits=num_splits, **_torch_opts(opts)).numpy()
    live = kvl > 0
    np.testing.assert_allclose(got[live], np.asarray(ref)[live], rtol=2e-5,
                               atol=2e-5)
    assert not got[~live].any()


def test_cpu_wrapper_takes_num_splits():
    q, pool, kvl, pt = _setup(23, [90, 3, 200], 8, 2, 64, 16)
    args = (T_(q), T_(pool), T_(kvl), T_(pt))
    ref = dec.paged_decode_attention(*args, sm_scale=0.125)
    got = dec.paged_decode_attention(*args, sm_scale=0.125, num_splits=3,
                                     max_kv_len=200)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


# ---- (c) the host rule --------------------------------------------------

SMS = 132


def test_choose_splits_full_batch_of_short_rows_is_one():
    assert dec.choose_splits(64, 4, 160, SMS, group=8) == 1
    assert dec.choose_splits(256, 8, 4096, SMS, group=4) == 1


def test_choose_splits_few_long_rows_split():
    n = dec.choose_splits(4, 4, 16384, SMS, group=8)
    assert n > 1
    assert 4 * 4 * n >= SMS                      # a CTA for every SM
    assert dec.choose_splits(1, 1, 1 << 20, SMS) == SMS


@pytest.mark.parametrize("seqs", [1, 3, 16, 64, 500])
@pytest.mark.parametrize("kvh,group", [(1, 8), (4, 8), (8, 1), (2, 40)])
@pytest.mark.parametrize("max_kv", [0, 1, 31, 255, 256, 1000, 5000, 70000])
def test_choose_splits_bounds(seqs, kvh, group, max_kv):
    n = dec.choose_splits(seqs, kvh, max_kv, SMS, group=group)
    assert isinstance(n, int) and n >= 1
    tiles = max(1, -(-max_kv // dec.SPLIT_TILE))
    assert n <= tiles                            # never more than tiles
    if n > 1:                                    # never under the floor
        assert max_kv // n >= dec.MIN_SPLIT
    # more rows never ask for more splits
    assert dec.choose_splits(seqs * 2, kvh, max_kv, SMS, group=group) <= n


def test_choose_splits_is_a_function_of_host_ints():
    params = inspect.signature(dec.choose_splits).parameters
    assert all(p.annotation in (int, "int") for p in params.values())
    assert dec.choose_splits(8, 4, 3000, SMS, 8) == \
        dec.choose_splits(8, 4, 3000, SMS, 8)


# ---- (d) the engine's hint ----------------------------------------------

@pytest.fixture(scope="module")
def llm():
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig
    llm = LLM("tests/assets/tinycode-llama", device="cpu", dtype="float32",
              skip_tokenizer_init=True, max_batch_size=4, max_input_len=64,
              max_seq_len=128, max_num_tokens=64,
              kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                            max_tokens=1024))
    yield llm
    llm.shutdown()


def test_max_kv_len_bounds_every_step(llm, monkeypatch):
    """Through ``LLM.generate``: every attention call of the prefill steps
    (``prepare_inputs``) and of every step of a K-step decode window gets a
    ``max_kv_len`` that is an upper bound of its rows' ``kv_lens``, and the
    prefill steps' bound is exact. A decode step's bound is fixed for its
    CUDA graph's key: a power of two (or the page table's reach) covering
    the window's start and depth."""
    from tensorrt_llm_tpu_torch import SamplingParams
    seen = []
    real = tattn.ragged_paged_attention

    def spy(q, kv_pages, metadata, **kw):
        seen.append((metadata.max_q_len, metadata.max_kv_len,
                     int(metadata.kv_lens.max())))
        return real(q, kv_pages, metadata, **kw)

    import tensorrt_llm_tpu_torch.models.modeling_utils as mu
    name = next(n for n, v in vars(mu).items() if v is real)
    monkeypatch.setattr(mu, name, spy)
    prompts = [[5, 9, 23, 44, 17], list(range(2, 40)), [1] * 20]
    outs = llm.generate(prompts, [SamplingParams(max_tokens=n, top_k=1)
                                  for n in (12, 5, 20)])
    assert [len(o.outputs[0].token_ids) for o in outs] == [12, 5, 20]
    assert seen
    prefill = [s for s in seen if s[0] > 1]
    decode = [s for s in seen if s[0] == 1]
    assert prefill and decode
    for max_q, bound, true_max in seen:
        assert bound is not None and bound >= true_max
    assert all(bound == true_max for _, bound, true_max in prefill)
    # one bound per window: the longest row's start plus the window's
    # depth (8), rounded up to a power of two, so at most twice that
    reach = llm.engine.pages_per_seq * llm.engine.page_size
    for _, bound, true_max in decode:
        assert bound == reach or bound & (bound - 1) == 0
        assert bound <= 2 * (true_max + 8)


def test_prepare_inputs_fills_max_kv_len(llm, monkeypatch):
    """``prepare_inputs`` states the longest KV length of the batch it
    flattened, exactly."""
    from tensorrt_llm_tpu_torch import SamplingParams
    engine = llm.engine
    real = engine.prepare_inputs
    seen = []

    def spy(batch):
        inp = real(batch)
        seen.append((inp.max_kv_len, int(inp.kv_lens.max())))
        return inp

    monkeypatch.setattr(engine, "prepare_inputs", spy)
    llm.generate([[3, 4, 5, 6], list(range(7, 60))],
                 SamplingParams(max_tokens=3, top_k=1))
    assert seen and all(a == b for a, b in seen)
    assert max(a for a, _ in seen) >= 53


# ---- routes and the dispatch's hint --------------------------------------

def test_prefill_route_by_dtype():
    from tensorrt_llm_tpu_torch.ops.cuda import prefill_attention as pre
    assert pre.route_for(torch.bfloat16) == "tensor_core"
    assert pre.route_for(torch.float32) == "float32_simple"
    with pytest.raises(TypeError):
        pre.route_for(torch.float16)


def test_dispatch_hands_max_kv_len_to_the_decode_wrapper(monkeypatch):
    """A decode-only batch reaches ``paged_decode_attention`` with the
    metadata's host bound; a mixed batch goes to the prefill kernel."""
    q, pool, kvl, pt = _setup(24, [20, 1, 33], 8, 2, 64, 16)
    got = {}

    def spy(q, kv_pages, kv_lens, page_indices, **kw):
        got.update(kw)
        return dec.paged_decode_attention_plain(
            q, kv_pages, kv_lens, page_indices, sm_scale=kw["sm_scale"])

    monkeypatch.setattr(tattn, "paged_decode_attention", spy)
    S = len(kvl)
    md = tattn.AttentionMetadata(
        kv_lens=T_(kvl), page_indices=T_(pt),
        cu_q_lens=torch.arange(S + 1, dtype=torch.int32),
        num_seqs=torch.tensor([S], dtype=torch.int32),
        slot_mapping=torch.zeros(S, dtype=torch.int32),
        positions=torch.zeros(S, dtype=torch.int32),
        logits_indices=torch.zeros(S, dtype=torch.int32),
        max_q_len=1, max_kv_len=33)
    out = tattn.ragged_paged_attention(T_(q), T_(pool), md, sm_scale=0.125)
    assert got["max_kv_len"] == 33
    ref = dec.paged_decode_attention_plain(T_(q), T_(pool), T_(kvl), T_(pt),
                                           sm_scale=0.125)
    torch.testing.assert_close(out, ref)
