"""The KV host and disk tiers and the KV connectors in the port
(runtime/kv_cache_manager.py, kv_tiers.py, kv_connector.py, the engine's
page movers) against the JAX package on the CPU, float32:

- the counterparts of tests/test_kv_host_tier.py and test_kv_disk_tier.py
  on both packages' block managers over one stand-in device (the same
  stats, the same pages restored), and of the disk store's semantics
  (LRU and priority eviction, backpressure, ``get_many``), with torch
  tensors (bf16) and ``HostPage``s beside numpy arrays;
- ``LLM`` runs with the host tier, with the disk tier under a small host
  tier, and with each connector of tests/test_kv_connector.py (the disk
  connector across a restart): greedy tokens and tier stats equal to the
  JAX ``LLM``'s, the pool's address unchanged by onboarding (the decode
  steps run the graph runner's static-buffer path), and an INT8 pool;
- the refusals of the tiers and connectors on a model without one KV
  pool (VSWA, recurrent state, image groups, Mllama's cross cache),
  beside the JAX movers that fail on such a pool.
"""
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu.runtime import kv_cache_manager as jkv
from tensorrt_llm_tpu.runtime import kv_connector as jconn
from tensorrt_llm_tpu.runtime import kv_tiers as jtiers
from tensorrt_llm_tpu.runtime.request import LlmRequest as JReq
from tensorrt_llm_tpu.sampling_params import SamplingParams as JSp
from tensorrt_llm_tpu_torch.runtime import kv_cache_manager as tkv
from tensorrt_llm_tpu_torch.runtime import kv_connector as tconn
from tensorrt_llm_tpu_torch.runtime import kv_tiers as ttiers
from tensorrt_llm_tpu_torch.runtime.model_engine import _ptrs
from tensorrt_llm_tpu_torch.runtime.request import LlmRequest as TReq
from tensorrt_llm_tpu_torch.sampling_params import SamplingParams as TSp

STATS = ("offloaded_blocks", "onboarded_blocks", "disk_blocks",
         "disk_onboarded_blocks", "host_blocks", "reused_blocks",
         "missed_blocks", "free_blocks")


class FakeDevice:
    """Stands in for the engine's page movers."""

    def __init__(self, n):
        self.pages = {i: np.zeros(4) for i in range(n)}

    def write(self, bid, content):
        self.pages[bid] = np.asarray(content, float)

    def offload(self, bid):
        return self.pages[bid].copy()

    def onboard(self, bid, data):
        self.pages[bid] = np.asarray(data, float)


def _req(pkg, tokens, max_tokens=8):
    if pkg is jkv:
        return JReq(prompt_token_ids=list(tokens),
                    sampling_params=JSp(max_tokens=max_tokens))
    r = TReq(prompt_token_ids=list(tokens),
             sampling_params=TSp(max_tokens=max_tokens))
    # the port stores only positions the device wrote (its manager's
    # docstring): here every prompt position
    r.num_device_tokens = len(tokens)
    return r


def _stats(mgr):
    s = mgr.get_stats()
    return {k: getattr(s, k) for k in STATS}


def _both(fn, tmp_path=None):
    """``fn(pkg, dev, disk_dir)`` on each package's manager module: its
    results, which must be equal."""
    out = []
    for i, pkg in enumerate((jkv, tkv)):
        d = None if tmp_path is None else tmp_path / str(i)
        out.append(fn(pkg, d))
    assert out[0] == out[1], out
    return out[1]


# --------------------------------------------------------------------- #
# block managers (tests/test_kv_host_tier.py, test_kv_disk_tier.py)
# --------------------------------------------------------------------- #
def test_offload_and_onboard_roundtrip():
    def run(pkg, _):
        dev = FakeDevice(4)
        kv = pkg.KVCacheManager(num_blocks=4, tokens_per_block=4,
                                host_cache_blocks=8,
                                offload_fn=dev.offload,
                                onboard_fn=dev.onboard)
        a = _req(pkg, range(8))
        kv.add_sequence(a)
        for bid in a.kv_block_ids:
            dev.write(bid, np.full(4, 10.0 + bid))
        a_blocks = list(a.kv_block_ids)
        kv.free_resources(a)
        # pressure: all 4 blocks for b, so a's 2 stored blocks offload
        b = _req(pkg, range(100, 116))
        kv.add_sequence(b)
        kv.free_resources(b, store_for_reuse=False)
        c = _req(pkg, list(range(8)) + [1, 2, 3, 4])
        reused = kv.add_sequence(c)
        restored = [dev.pages[bid][0] for bid in c.kv_block_ids[:2]]
        return (reused, restored, [10.0 + b for b in a_blocks], _stats(kv))
    reused, restored, want, st = _both(run)
    assert reused == 8 and restored == want
    assert st["offloaded_blocks"] >= 2 and st["onboarded_blocks"] >= 2


def test_host_tier_capacity_bound():
    def run(pkg, _):
        dev = FakeDevice(4)
        kv = pkg.KVCacheManager(num_blocks=4, tokens_per_block=4,
                                host_cache_blocks=1,
                                offload_fn=dev.offload,
                                onboard_fn=dev.onboard)
        a = _req(pkg, range(8))
        kv.add_sequence(a)
        kv.free_resources(a)
        kv.add_sequence(_req(pkg, range(50, 66)))
        return _stats(kv)
    assert _both(run)["host_blocks"] <= 1


def test_priority_below_the_threshold_is_dropped_not_offloaded():
    def run(pkg, _):
        dev = FakeDevice(4)
        kv = pkg.KVCacheManager(num_blocks=4, tokens_per_block=4,
                                host_cache_blocks=8,
                                offload_fn=dev.offload,
                                onboard_fn=dev.onboard,
                                secondary_offload_min_priority=50)
        a = _req(pkg, range(8))
        kv.add_sequence(a)
        kv.update_priority(a, 20)
        kv.free_resources(a)
        kv.add_sequence(_req(pkg, range(100, 116)))
        return _stats(kv)
    st = _both(run)
    assert st["offloaded_blocks"] == 0 and st["host_blocks"] == 0


def test_without_host_tier_still_evicts():
    def run(pkg, _):
        kv = pkg.KVCacheManager(num_blocks=4, tokens_per_block=4)
        a = _req(pkg, range(8))
        kv.add_sequence(a)
        kv.free_resources(a)
        b = _req(pkg, range(100, 116))
        kv.add_sequence(b)
        return len(b.kv_block_ids)
    assert _both(run) == 4


def test_three_tier_demotion_and_promotion(tmp_path):
    """Fill the pool, overflow the host tier into disk, then hit the
    prefix: the block promotes disk -> device with its bytes intact, and
    the managers' stats and events agree."""
    def run(pkg, d):
        tiers = jtiers if pkg is jkv else ttiers
        dev = FakeDevice(4)
        store = tiers.DiskKvStore(str(d), max_blocks=8)
        mgr = pkg.KVCacheManager(num_blocks=4, tokens_per_block=4,
                                 host_cache_blocks=1,
                                 offload_fn=dev.offload,
                                 onboard_fn=dev.onboard, disk_store=store,
                                 event_buffer_max_size=64)
        prompts = [[i, i, i, i, i + 10] for i in (1, 2, 3)]
        for i, p in enumerate(prompts):
            r = _req(pkg, p, 4)
            mgr.add_sequence(r)
            dev.write(r.kv_block_ids[0], np.full(4, float(i + 1)))
            r.num_device_tokens = len(p)
            mgr.free_resources(r, store_for_reuse=True)
        big = _req(pkg, range(40, 53), 2)
        mgr.add_sequence(big, enable_reuse=False)
        disk = mgr.get_stats().disk_blocks
        mgr.free_resources(big, store_for_reuse=False)
        r2 = _req(pkg, prompts[0], 4)
        reused = mgr.add_sequence(r2)
        store.shutdown()
        kinds = [e.kind for e in mgr.get_latest_events()]
        return (disk, reused, dev.pages[r2.kv_block_ids[0]][0],
                _stats(mgr), kinds)
    disk, reused, page, st, kinds = _both(run, tmp_path)
    assert disk >= 1 and reused == 4 and page == 1.0
    assert st["disk_onboarded_blocks"] >= 1
    assert "offloaded" in kinds and "demoted_disk" in kinds


def test_claimed_node_survives_a_full_host_tier():
    """A prefix block at the head of a full host LRU is claimed while the
    pool is full: the allocation offloads a block and overflows the LRU.
    The port drops the next-oldest entry and onboards the prefix's page;
    the JAX manager drops the claimed node's own data and onboards None
    (the stand-in device then holds nan; the engine's mover raises)."""
    def run(pkg):
        dev = FakeDevice(4)
        kv = pkg.KVCacheManager(num_blocks=4, tokens_per_block=4,
                                host_cache_blocks=2,
                                offload_fn=dev.offload,
                                onboard_fn=dev.onboard)
        for i, tok in enumerate((0, 1)):          # prefixes a0, x0
            r = _req(pkg, [tok] * 4 + [9])
            kv.add_sequence(r)
            dev.write(r.kv_block_ids[0], np.full(4, 1.0 + i))
            kv.free_resources(r)
        b = _req(pkg, range(100, 116))            # offloads a0, then x0
        kv.add_sequence(b, enable_reuse=False)
        kv.free_resources(b, store_for_reuse=False)
        c = _req(pkg, range(200, 216))            # fills the pool
        kv.add_sequence(c)
        c.num_device_tokens = 16
        kv.free_resources(c)
        d = _req(pkg, [0] * 4 + [7])
        reused = kv.add_sequence(d)
        page = np.ravel(dev.pages[d.kv_block_ids[0]])[0]
        return reused, float(page), _stats(kv)

    reused, page, st = run(tkv)
    assert reused == 4 and page == 1.0
    assert st["onboarded_blocks"] == 1 and st["host_blocks"] <= 2
    j_reused, j_page, _ = run(jkv)
    assert j_reused == 4 and np.isnan(j_page)


def test_disk_store_roundtrip(tmp_path):
    store = ttiers.DiskKvStore(str(tmp_path), max_blocks=2)
    k1 = store.put(np.arange(8.0))
    np.testing.assert_allclose(store.get(k1), np.arange(8.0))
    k2 = store.put(np.ones(4))
    k3 = store.put(np.zeros(4))   # LRU-evicts k1 (capacity 2)
    store._writer.shutdown(wait=True)
    assert store.get(k1) is None
    np.testing.assert_allclose(store.get(k2), np.ones(4))
    np.testing.assert_allclose(store.get(k3), np.zeros(4))
    assert len(store) == 2


def test_disk_store_keeps_torch_pages(tmp_path):
    """bf16 pages (no numpy type) and ``HostPage``s round-trip as torch
    tensors; the stored bytes are the tensors'."""
    st = ttiers.DiskKvStore(str(tmp_path))
    g = torch.Generator().manual_seed(0)
    a = torch.randn(2, 4, 3, generator=g).bfloat16()
    b = torch.randn(5, generator=g)
    ka, kb = st.put(a), st.put(ttiers.HostPage(b))
    outs = st.get_many([ka, kb])
    assert outs[0].dtype == torch.bfloat16 and torch.equal(outs[0], a)
    assert torch.equal(outs[1], b)
    assert st.stats.bytes_stored == a.numel() * 2 + b.numel() * 4
    st.shutdown()


def test_disk_tier_byte_capacity_and_priority_eviction(tmp_path):
    blk = np.ones((4, 1024), np.float32)           # 16 KB each
    st = ttiers.DiskKvStore(str(tmp_path / "d"),
                            max_bytes=3 * blk.nbytes + 1)
    k_low = st.put(blk, priority=10)
    k_hi1 = st.put(blk * 2, priority=80)
    k_hi2 = st.put(blk * 3, priority=80)
    k_new = st.put(blk * 4, priority=50)           # over budget now
    st.shutdown()
    assert st.get(k_low) is None                   # lowest priority went
    assert st.stats.evictions == 1
    for k, mul in ((k_hi1, 2), (k_hi2, 3), (k_new, 4)):
        got = st.get(k)
        assert got is not None and got[0, 0] == mul


def test_disk_tier_write_backpressure(tmp_path):
    blk = np.ones((1024, 256), np.float32)         # 1 MB
    st = ttiers.DiskKvStore(str(tmp_path / "d"),
                            max_inflight_bytes=2 * blk.nbytes + 1)
    keys = [st.put(blk) for _ in range(8)]
    dropped = sum(k is None for k in keys)
    st.shutdown()
    assert st.stats.put_drops == dropped
    for k in keys:
        if k is not None:
            assert st.get(k) is not None


def test_disk_tier_stats_and_get_many(tmp_path):
    st = ttiers.DiskKvStore(str(tmp_path / "d"))
    ks = [st.put(np.full((8,), i, np.int32)) for i in range(4)]
    outs = st.get_many(ks + ["missing"])
    assert [o[0] for o in outs[:4]] == [0, 1, 2, 3]
    assert outs[4] is None
    d = st.stats.as_dict()
    assert d["puts"] == 4 and d["hits"] == 4 and d["misses"] >= 1
    assert d["bytes_stored"] == 4 * 32
    assert d["read_seconds"] > 0 and 0 <= d["read_waits"] <= 4
    st.shutdown()


# --------------------------------------------------------------------- #
# LLM
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def tmodel():
    from transformers import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(0)
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=512)
    return LlamaForCausalLM(cfg).eval()


def _llm(pkg, tmodel, kv=None, **kw):
    args = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=2,
                max_input_len=96, max_seq_len=128, max_num_tokens=256)
    args.update(kw)
    kvc = pkg.KvCacheConfig(**dict(dict(tokens_per_block=16,
                                        max_tokens=1024), **(kv or {})))
    if pkg is T:
        return T.LLM(tmodel, device="cpu", kv_cache_config=kvc, **args)
    return J.LLM(model=tmodel, kv_cache_config=kvc, **args)


def _tier_run(pkg, tmodel, kv, prefix, churn, sp_kw):
    """The JAX test_kv_disk_tier.py e2e traffic: a prefix, disjoint
    requests that evict it, the prefix again. Returns tokens, the KV
    manager's stats, the last request's reused tokens and the engine."""
    llm = _llm(pkg, tmodel, kv)
    try:
        sp = pkg.SamplingParams(**sp_kw)
        ptrs = None if pkg is J else _ptrs(llm.engine.kv_pages)
        first = llm.generate(prefix, sp).outputs[0].token_ids
        for p in churn:
            llm.generate(p, sp)
        again = llm.generate(prefix, sp)
        st = _stats(llm.kv_cache_manager)
        if pkg is T:
            assert _ptrs(llm.engine.kv_pages) == ptrs
        return (first, again.outputs[0].token_ids, st,
                again._result.request.perf.kv_cache_hit_tokens, llm.engine)
    finally:
        llm.shutdown()


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_llm_tiers_match_jax(tmodel, tmp_path, tier):
    """A 4-block prefix survives eviction through the host tier (or the
    disk tier under a one-block host tier): tokens, hits and the tier
    stats equal the JAX ``LLM``'s. The pool's address never changes (the
    onboarded pages are written in place), and the engine counts its
    page moves."""
    kv = dict(max_tokens=8 * 16, host_cache_size=1 if tier == "disk"
              else 64 << 20)
    prefix = list(range(2, 66))
    churn = [[70 + i] * 40 for i in range(4)]
    sp = dict(max_tokens=4, top_k=1)
    runs = []
    for i, pkg in enumerate((J, T)):
        if tier == "disk":
            kv["disk_cache_dir"] = str(tmp_path / str(i))
        runs.append(_tier_run(pkg, tmodel, kv, prefix, churn, sp))
    (jf, ja, jst, jhit, _), (tf_, ta, tst, thit, eng) = runs
    assert tf_ == jf and ta == ja and ta == tf_
    assert tst == jst
    assert thit == jhit > 0
    assert tst["onboarded_blocks"] >= 3
    if tier == "disk":
        assert tst["disk_blocks"] >= 1 and tst["disk_onboarded_blocks"] >= 1
    moves = eng.kv_moves
    assert moves["d2h_pages"] == tst["offloaded_blocks"]
    assert moves["h2d_pages"] == tst["onboarded_blocks"]
    assert moves["h2d_bytes"] == moves["h2d_pages"] * eng.bytes_per_kv_block
    assert moves["host_syncs"] == 0
    assert any(k[0] == "multi" for k in eng.graphs.steps)


def test_llm_host_tier_on_an_int8_pool(tmodel):
    """An 8-bit pool's pages move as bytes: the tokens equal those of a
    pool that holds everything."""
    from tensorrt_llm_tpu_torch.quantization.mode import KvCacheQuantAlgo
    qc = T.QuantConfig(kv_cache_quant_algo=KvCacheQuantAlgo.INT8)
    prefix = list(range(2, 66))
    churn = [[70 + i] * 40 for i in range(4)]
    out = []
    for kv in (dict(max_tokens=8 * 16, host_cache_size=64 << 20),
               dict(max_tokens=2048)):
        llm = _llm(T, tmodel, kv, quant_config=qc)
        try:
            sp = T.SamplingParams(max_tokens=4, top_k=1)
            toks = [llm.generate(p, sp).outputs[0].token_ids
                    for p in [prefix] + churn + [prefix]]
            out.append((toks, llm.kv_cache_manager.get_stats()
                        .onboarded_blocks))
        finally:
            llm.shutdown()
    assert out[0][0] == out[1][0]
    assert out[0][1] >= 3 and out[1][1] == 0


def _connector_run(pkg, tmodel, conn, prompt, n_gen, reuse=False):
    llm = _llm(pkg, tmodel, dict(enable_block_reuse=reuse),
               max_batch_size=4, max_input_len=64,
               **({} if conn is None
                  else dict(kv_connector_config={"instance": conn})))
    try:
        sp = pkg.SamplingParams(max_tokens=8, top_k=1)
        return [llm.generate(prompt, sp).outputs[0].token_ids
                for _ in range(n_gen)]
    finally:
        llm.shutdown()


def test_connector_load_path_matches_jax(tmodel):
    """Save on request 1, load on request 2 (block reuse off, so the
    connector is the only prefix source): tokens equal a connector-less
    engine's and the JAX ``LLM``'s, with the same saved / loaded
    counts."""
    prompt = list(range(2, 36))      # 34 tokens: 2 full blocks of 16
    ref = _connector_run(T, tmodel, None, prompt, 1)[0]
    out = {}
    for pkg, mod in ((J, jconn), (T, tconn)):
        conn = mod.HostMemoryKvConnector(tokens_per_block=16)
        out[pkg.__name__] = (_connector_run(pkg, tmodel, conn, prompt, 2),
                             dict(conn.stats))
    (jt, jstats), (tt, tstats) = out.values()
    assert tt == jt == [ref, ref]
    assert tstats == jstats and tstats["loaded_blocks"] >= 2


def test_connector_respects_radix_reuse(tmodel):
    prompt = list(range(3, 37))
    conn = tconn.HostMemoryKvConnector(tokens_per_block=16)
    a, b = _connector_run(T, tmodel, conn, prompt, 2, reuse=True)
    assert a == b
    assert conn.stats["loaded_blocks"] == 0


def test_scheduler_output_plumbed(tmodel):
    seen = []

    class Spy(tconn.HostMemoryKvConnector):
        def build_connector_meta(self, scheduler_output):
            for r in scheduler_output.new_requests:
                seen.append((r.request_id, len(r.new_block_ids)))
            return None

    _connector_run(T, tmodel, Spy(tokens_per_block=16), [1, 2, 3, 4, 5], 1)
    assert len(seen) == 1 and seen[0][1] >= 1


def test_connector_from_module_and_class(tmodel):
    """``kv_connector_config`` by module and class names, with kwargs."""
    llm = _llm(T, tmodel, dict(enable_block_reuse=False),
               kv_connector_config={
                   "connector_module":
                       "tensorrt_llm_tpu_torch.runtime.kv_connector",
                   "connector_worker_class": "HostMemoryKvConnector",
                   "kwargs": {"tokens_per_block": 16}})
    try:
        conn = llm.executor.kv_connector
        assert conn.scheduler is conn.worker
        sp = T.SamplingParams(max_tokens=4, top_k=1)
        prompt = list(range(2, 36))
        toks = [llm.generate(prompt, sp).outputs[0].token_ids
                for _ in range(2)]
        assert toks[0] == toks[1] and conn.worker.stats["loaded_blocks"] == 2
    finally:
        llm.shutdown()


def test_disk_connector_survives_restart(tmodel, tmp_path):
    """Prefixes saved by one engine re-serve from a fresh engine over the
    same directory, as in the JAX package."""
    prompt = list(range(2, 36))
    c1 = tconn.DiskKvConnector(tokens_per_block=16, cache_dir=str(tmp_path))
    ref = _connector_run(T, tmodel, c1, prompt, 1)[0]
    assert c1.stats["saved_blocks"] > 0
    c2 = tconn.DiskKvConnector(tokens_per_block=16, cache_dir=str(tmp_path))
    assert len(c2._store) > 0          # adopted the saved blocks
    got = _connector_run(T, tmodel, c2, prompt, 1)[0]
    assert got == ref
    assert c2.stats["loaded_blocks"] >= 2
    jc = jconn.DiskKvConnector(tokens_per_block=16,
                               cache_dir=str(tmp_path / "jax"))
    assert _connector_run(J, tmodel, jc, prompt, 1)[0] == ref


# --------------------------------------------------------------------- #
# refusals, and the JAX movers on such pools
# --------------------------------------------------------------------- #
def _refused_models():
    import transformers as tf
    from tests.test_mllama import tiny_cfg
    from tests.test_torch_gemma3_vl import _paligemma_cfg
    torch.manual_seed(0)
    gemma = tf.Gemma2ForCausalLM(tf.Gemma2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, query_pre_attn_scalar=16, sliding_window=16,
        max_position_embeddings=256)).eval()
    mamba = tf.MambaForCausalLM(tf.MambaConfig(
        vocab_size=96, hidden_size=64, state_size=8, num_hidden_layers=2,
        conv_kernel=4, expand=2, time_step_rank=4)).eval()
    return {
        "vswa": (gemma, dict(max_attention_window=[16, 128]), "VSWA"),
        "recurrent": (mamba, {}, "recurrent state"),
        "image_groups": (tf.PaliGemmaForConditionalGeneration(
            _paligemma_cfg()).eval(), {}, "image groups"),
        "cross": (tf.MllamaForConditionalGeneration(tiny_cfg()).eval(), {},
                  "cross-attention"),
    }


@pytest.mark.parametrize("kind", ["vswa", "recurrent", "image_groups",
                                  "cross"])
def test_tiers_and_connectors_refused_without_one_pool(kind):
    """The port refuses the host tier and a connector by name on these
    models; the JAX package builds the ``LLM`` with the host tier all the
    same, and its page mover fails on the pool (a pair or a dict, which
    ``kv_pages[:, bid]`` cannot index)."""
    model, kv, what = _refused_models()[kind]
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=2,
              max_input_len=32, max_seq_len=64, max_num_tokens=64)
    for extra in (dict(kv_cache_config=T.KvCacheConfig(
            tokens_per_block=8, max_tokens=512, host_cache_size=1 << 20,
            **kv)),
            dict(kv_cache_config=T.KvCacheConfig(tokens_per_block=8,
                                                 max_tokens=512, **kv),
                 kv_connector_config={
                     "instance": tconn.HostMemoryKvConnector(8)})):
        with pytest.raises(NotImplementedError, match=what):
            T.LLM(model, device="cpu", **kw, **extra)
    j = J.LLM(model=model, kv_cache_config=J.KvCacheConfig(
        tokens_per_block=8, max_tokens=512, host_cache_size=1 << 20, **kv),
        **kw)
    try:
        with pytest.raises(TypeError):
            j.engine.offload_page(0)
    finally:
        j.shutdown()
