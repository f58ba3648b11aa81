"""Host-orchestrated speculative decoding in the port, piece by piece,
against the JAX package on the CPU:

- the drafters: ``NGramDrafter`` and ``SuffixAutomatonDrafter`` (the
  port's copies) propose the JAX drafters' drafts on seeded histories
  with repeated structure, grown token by token (the counterparts of
  tests/test_speculative.py:18-38 and tests/test_suffix_automaton.py);
- the KV manager's ``add_draft_tokens`` / ``rewind_tokens``: block ids
  and free counts equal to the JAX manager's over a seeded workload of
  verify steps, with prefix reuse on, and with VSWA's two pools (a window
  no sequence outgrows, where the port's release rule and the JAX one
  agree; under a small window the port's own release rule); and the
  store rule that keeps a rejected draft's KV out of the reuse tree,
  where the JAX manager stores it;
- the engine: ``prepare_inputs`` with drafts equal to the JAX engine's
  field by field, and one verify step's tokens (exact) and logprobs
  (1e-5, float32) equal to the JAX engine's on tests/assets/tinycode-llama,
  greedy rows and top-k 1 sampled rows (deterministic under both
  packages' noise) through ``rejection_sample``; seeded sampled rows at
  the position ``pos_base + g`` (the port's noise cannot match
  ``jax.random``, so these are held to the port's own ``sample``);
- the refusals that stay, each by name.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.runtime import kv_cache_manager as jkv
from tensorrt_llm_tpu.runtime import request as jreq
from tensorrt_llm_tpu.sampling_params import SamplingParams as JSP
from tensorrt_llm_tpu.speculative import ngram as jngram
from tensorrt_llm_tpu.speculative import suffix_automaton as jsa
from tensorrt_llm_tpu_torch.runtime import kv_cache_manager as tkv
from tensorrt_llm_tpu_torch.runtime import request as treq
from tensorrt_llm_tpu_torch.sampling_params import SamplingParams as TSP
from tensorrt_llm_tpu_torch.speculative import ngram as tngram
from tensorrt_llm_tpu_torch.speculative import suffix_automaton as tsa

CKPT = Path(__file__).parent / "assets" / "tinycode-llama"
ATOL = 1e-5


class _Req:
    """What a drafter reads of a request."""

    def __init__(self, rid, tokens):
        self.request_id = rid
        self.all_token_ids = list(tokens)
        self.draft_tokens = []


def _history(rng, n):
    """A seeded history with repeated structure: random segments over a
    small vocabulary, each repeated with noise."""
    out = []
    while len(out) < n:
        seg = list(rng.integers(0, 9, size=int(rng.integers(2, 7))))
        for _ in range(int(rng.integers(1, 4))):
            out += seg
            if rng.random() < 0.3:
                out.append(int(rng.integers(0, 9)))
    return [int(t) for t in out[:n]]


def _drive(make, seed, n_reqs=3, steps=40):
    """Both packages' drafters over the same growing histories (a few
    tokens appended per step, requests dropped now and then): the drafts
    of every call."""
    rng = np.random.default_rng(seed)
    jd, td = make(jngram, jsa), make(tngram, tsa)
    hists = {r: _history(rng, int(rng.integers(4, 30)))
             for r in range(n_reqs)}
    full = {r: _history(rng, 200) for r in hists}
    out = []
    for step in range(steps):
        live = [r for r in hists if rng.random() < 0.8] or [0]
        jr = [_Req(r, hists[r]) for r in live]
        tr = [_Req(r, hists[r]) for r in live]
        jd.prepare_draft_tokens(jr)
        td.prepare_draft_tokens(tr)
        got = [r.draft_tokens for r in tr]
        assert got == [r.draft_tokens for r in jr], (seed, step)
        out += got
        for r in live:
            k = int(rng.integers(1, 4))
            hists[r] = hists[r] + full[r][len(hists[r]) % 150:][:k]
        if rng.random() < 0.1:
            r = int(rng.integers(n_reqs))
            jd.drop_request(r)
            td.drop_request(r)
            hists[r] = _history(rng, 5)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d,n", [(2, 1), (4, 3), (5, 5)])
def test_ngram_drafts_equal_jax(seed, d, n):
    drafts = _drive(lambda ng, sa: ng.NGramDrafter(
        max_draft_len=d, max_matching_ngram_size=n), seed)
    assert any(drafts)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("d,threshold,conc", [(3, 1, None), (4, 2, None),
                                               (4, 3, 2)])
def test_suffix_automaton_drafts_equal_jax(seed, d, threshold, conc):
    drafts = _drive(lambda ng, sa: sa.SuffixAutomatonDrafter(
        max_draft_len=d, threshold=threshold, max_concurrency=conc), seed)
    assert any(drafts)


def test_ngram_and_sa_unit_cases():
    """tests/test_speculative.py:18-38 and test_suffix_automaton.py's
    drafter cases on the port's copies."""
    def req(prompt, outputs=()):
        return _Req(0, list(prompt) + list(outputs))
    r = req([1, 2, 7, 8, 9, 10, 3], [5, 7, 8])
    tngram.NGramDrafter(2, 3).prepare_draft_tokens([r])
    assert r.draft_tokens == [9, 10]
    r = req([1, 2, 3, 50, 9, 2, 3, 99, 1, 2, 3])
    tngram.NGramDrafter(1, 4).prepare_draft_tokens([r])
    assert r.draft_tokens == [50]
    r = req([1, 2, 3, 4])
    tngram.NGramDrafter(4).prepare_draft_tokens([r])
    assert r.draft_tokens == []
    d = tsa.SuffixAutomatonDrafter(max_draft_len=3, threshold=3)
    r = _Req(1, [1, 2, 1, 2])
    d.prepare_draft_tokens([r])
    assert r.draft_tokens == []
    r = _Req(2, [1, 2, 3, 5, 1, 2, 3])
    d.prepare_draft_tokens([r])
    assert r.draft_tokens == [5, 1, 2]


# ---- the KV manager ------------------------------------------------------

def _pair(prompt, rid, max_tokens=64):
    return (jreq.LlmRequest(prompt, JSP(max_tokens=max_tokens),
                            request_id=rid),
            treq.LlmRequest(prompt, TSP(max_tokens=max_tokens),
                            request_id=rid))


def _verify_step(mgrs, pair, nd, acc, toks):
    """One verify step of ``nd`` drafts of which ``acc`` are accepted:
    KV for the input token and the drafts, the accepted tokens and the
    bonus appended, the device count rolled back and the rejected drafts'
    blocks rewound (the executor's sequence)."""
    for m, r in zip(mgrs, pair):
        m.add_token(r)
        if nd:
            m.add_draft_tokens(r, nd)
        r.num_device_tokens += 1 + nd
        r.output_token_ids.extend(toks[:acc + 1])
        if nd - acc:
            r.num_device_tokens -= nd - acc
            m.rewind_tokens(r, 0)


def _ids(r, attr="kv_block_ids"):
    return list(getattr(r, attr))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_draft_and_rewind_blocks_match_jax_with_reuse(seed):
    """Shared prefixes (radix reuse), verify steps with drafts and
    rejections, frees into the reuse tree and eviction under a small pool.
    A request is freed where its token count is not a whole number of
    pages: there both managers store the same blocks (where it is, the
    port keeps back the last block, ``test_rejected_draft_kv_is_never
    _stored_for_reuse``)."""
    rng = np.random.default_rng(seed)
    ps = 4
    mgrs = (jkv.KVCacheManager(num_blocks=60, tokens_per_block=ps),
            tkv.KVCacheManager(num_blocks=60, tokens_per_block=ps))
    prefixes = [list(rng.integers(0, 50, size=12)) for _ in range(3)]
    live, steps = [], 0
    for rid in range(50):
        for pair in list(live):
            if len(pair[1].all_token_ids) % ps and rng.random() < 0.3:
                live.remove(pair)
                for m, r in zip(mgrs, pair):
                    m.free_resources(r)
        prompt = prefixes[rid % 3] + list(rng.integers(0, 50, size=int(
            rng.integers(1, 9))))
        pair = _pair(prompt, rid)
        reused = []
        for m, r in zip(mgrs, pair):
            try:
                reused.append(m.add_sequence(r))
            except (jkv.NoFreeBlocksError, tkv.NoFreeBlocksError):
                reused.append("refused")
        assert reused[0] == reused[1]
        if reused[0] == "refused":
            continue
        for r in pair:        # the prefill step and its sampled token
            r.num_device_tokens = r.prompt_len
            r.output_token_ids.append(7)
        for _ in range(int(rng.integers(1, 5))):
            nd = int(rng.integers(0, 5))
            acc = int(rng.integers(0, nd + 1))
            toks = [int(t) for t in rng.integers(0, 50, size=acc + 1)]
            try:
                _verify_step(mgrs, pair, nd, acc, toks)
            except (jkv.NoFreeBlocksError, tkv.NoFreeBlocksError):
                break
            steps += 1
            assert _ids(pair[0]) == _ids(pair[1])
            assert mgrs[0].get_num_free_blocks() == \
                mgrs[1].get_num_free_blocks()
        live.append(pair)
    js, ts = mgrs[0].get_stats(), mgrs[1].get_stats()
    for f in ("free_blocks", "used_blocks", "reusable_blocks",
              "reused_blocks", "missed_blocks", "alloc_new_blocks"):
        assert getattr(js, f) == getattr(ts, f), f
    assert ts.reused_blocks > 0 and steps > 50


def _vswa(pkg, kv, num, window, ps):
    if pkg == "jax":
        return kv.VswaKvManager(
            kv.KVCacheManager(num_blocks=num, tokens_per_block=ps,
                              enable_block_reuse=False),
            kv.KVCacheManager(num_blocks=num, tokens_per_block=ps,
                              enable_block_reuse=False), window=window)
    return kv.VswaKvManager(
        kv.KVCacheManager(num_blocks=num, tokens_per_block=ps,
                          enable_block_reuse=False),
        kv.KVCacheManager(num_blocks=num, tokens_per_block=ps,
                          enable_block_reuse=False,
                          ids_attr="kv_block_ids_sw"), window=window)


@pytest.mark.parametrize("seed", [0, 1])
def test_draft_and_rewind_match_jax_under_vswa(seed):
    """Both pools grow by the drafts and rewind together. The window (128)
    is longer than any sequence, so neither release rule frees a sliding
    block and the two packages' ids and free counts agree."""
    rng = np.random.default_rng(seed)
    ps = 4
    mgrs = (_vswa("jax", jkv, 80, 128, ps), _vswa("torch", tkv, 80, 128, ps))
    live = []
    for rid in range(20):
        if live and rng.random() < 0.4:
            pair = live.pop(int(rng.integers(len(live))))
            for m, r in zip(mgrs, pair):
                m.free_resources(r)
        pair = _pair([int(t) for t in rng.integers(0, 50, size=int(
            rng.integers(3, 12)))], rid)
        for m, r in zip(mgrs, pair):
            m.add_sequence(r)
            r.num_device_tokens = r.prompt_len
            r.output_token_ids.append(3)
        for _ in range(int(rng.integers(1, 6))):
            nd = int(rng.integers(0, 5))
            acc = int(rng.integers(0, nd + 1))
            _verify_step(mgrs, pair, nd, acc, [5] * (acc + 1))
            for attr in ("kv_block_ids", "kv_block_ids_sw"):
                assert _ids(pair[0], attr) == _ids(pair[1], attr)
            assert mgrs[0].g.get_num_free_blocks() == \
                mgrs[1].g.get_num_free_blocks()
            assert mgrs[0].s.get_num_free_blocks() == \
                mgrs[1].s.get_num_free_blocks()
        live.append(pair)


def test_rewind_under_a_small_window_keeps_the_port_release_rule():
    """Window 8, page 4: the sliding pool releases the blocks wholly below
    the step's first query less the window (the port's rule) and a rewind
    never releases a released block again: every block is free or held
    exactly once."""
    rng = np.random.default_rng(5)
    ps, num = 4, 64
    m = _vswa("torch", tkv, num, 8, ps)
    reqs = []
    for rid in range(3):
        r = treq.LlmRequest([1] * 6, TSP(max_tokens=200), request_id=rid)
        m.add_sequence(r)
        r.num_device_tokens = 6
        r.output_token_ids.append(2)
        reqs.append(r)
    for _ in range(30):
        for r in reqs:
            nd = int(rng.integers(0, 5))
            acc = int(rng.integers(0, nd + 1))
            _verify_step((m,), (r,), nd, acc, [4] * (acc + 1))
            first = r.num_device_tokens
            held = m.s._seq_blocks[r.request_id]
            trimmed = sum(isinstance(b, tkv._TrimmedBlock) for b in held)
            assert trimmed <= max(0, first - 8 + 1) // ps
        held = [b.block_id for r in reqs for b in m.s._seq_blocks[
            r.request_id] if not isinstance(b, tkv._TrimmedBlock)]
        assert len(held) == len(set(held))
        assert m.s.get_num_free_blocks() + len(held) == num
    assert m.trimmed_blocks > 0


def test_rejected_draft_kv_is_never_stored_for_reuse():
    """A request stops on its bonus token, which closes a page: that
    position holds the rejected draft's KV, not the bonus token's. The
    JAX manager stores the page in the reuse tree by the token count, so a
    later prompt that extends those tokens reuses it (8 tokens); the port
    stores only pages below ``num_device_tokens`` (4 tokens), so the
    position is recomputed."""
    ps = 4
    mgrs = (jkv.KVCacheManager(num_blocks=16, tokens_per_block=ps),
            tkv.KVCacheManager(num_blocks=16, tokens_per_block=ps))
    pair = _pair([10, 11, 12, 13, 14], 0)
    for m, r in zip(mgrs, pair):
        m.add_sequence(r)
        r.num_device_tokens = 5
        r.output_token_ids.append(20)
    # input 20 at position 5, drafts 21 22 23 at 6-8; 21 accepted, the
    # bonus 30 at position 7, where draft 22's KV sits
    _verify_step(mgrs, pair, 3, 1, [21, 30])
    assert pair[1].all_token_ids == [10, 11, 12, 13, 14, 20, 21, 30]
    assert pair[1].num_device_tokens == 7
    for m, r in zip(mgrs, pair):
        m.free_resources(r)
    probe = _pair([10, 11, 12, 13, 14, 20, 21, 30, 40], 1)
    reused = [m.add_sequence(r) for m, r in zip(mgrs, probe)]
    assert reused == [8, 4]


def test_unwritten_last_token_is_never_stored_for_reuse():
    """A sequence without drafts stops on a token that closes a page: a
    decode step writes the KV of the token it consumes, so the last
    token's KV was never written. The JAX manager stores the page by the
    token count, and a later prompt that extends those tokens reuses it (8
    tokens), reading the unwritten position; the port stores only pages
    below ``num_device_tokens`` (4 tokens)."""
    ps = 4
    mgrs = (jkv.KVCacheManager(num_blocks=16, tokens_per_block=ps),
            tkv.KVCacheManager(num_blocks=16, tokens_per_block=ps))
    pair = _pair([10, 11, 12, 13, 14], 0)
    for m, r in zip(mgrs, pair):
        m.add_sequence(r)
        r.num_device_tokens = 5          # the prefill wrote the prompt
        r.output_token_ids.append(20)    # and sampled position 5
    # two decode steps feed 20 and 21 (positions 5, 6) and sample 21, 22;
    # 22 at position 7 closes the second page and the request stops
    _verify_step(mgrs, pair, 0, 0, [21])
    _verify_step(mgrs, pair, 0, 0, [22])
    assert pair[1].all_token_ids == [10, 11, 12, 13, 14, 20, 21, 22]
    assert pair[1].num_device_tokens == 7
    for m, r in zip(mgrs, pair):
        m.free_resources(r)
    probe = _pair([10, 11, 12, 13, 14, 20, 21, 22, 40], 1)
    reused = [m.add_sequence(r) for m, r in zip(mgrs, probe)]
    assert reused == [8, 4]


def test_prompt_extending_a_finished_request_is_served_right():
    """End to end on tests/assets/tinycode-llama (float32, page 16, the
    sync scheduler, one-token steps): request A's 13 prompt tokens and 3
    outputs fill a page whose last position's KV was never written. B's
    prompt extends A's tokens. With prefix reuse the port gives B the
    tokens and logprobs (1e-5) of an engine without reuse; the JAX
    ``LLM`` reuses the unwritten position and its logprobs for B part
    from the run without reuse."""
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=64, max_seq_len=128, max_num_tokens=256,
              decode_multi_step=1, disable_overlap_scheduler=True)
    a = list(b"def f(x):\n  r")
    assert len(a) == 13
    runs = {}
    for pkg, mod in (("jax", J), ("torch", T)):
        for reuse in (True, False):
            extra = {} if pkg == "jax" else dict(device="cpu")
            llm = mod.LLM(model=CKPT, **extra, **kw,
                          kv_cache_config=mod.KvCacheConfig(
                              tokens_per_block=16, max_tokens=1024,
                              enable_block_reuse=reuse))
            try:
                sp = mod.SamplingParams(max_tokens=3, top_k=1,
                                        ignore_eos=True)
                out_a = llm.generate(a, sp).outputs[0].token_ids
                b = a + out_a + [32, 40]
                o = llm.generate(b, mod.SamplingParams(
                    max_tokens=6, top_k=1, ignore_eos=True,
                    logprobs=1)).outputs[0]
                runs[pkg, reuse] = (o.token_ids, [
                    v for d in o.logprobs for v in d.values()])
            finally:
                llm.shutdown()
    got, want = runs["torch", True], runs["torch", False]
    assert got[0] == want[0] == runs["jax", False][0]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    jax_reuse, jax_fresh = runs["jax", True], runs["jax", False]
    assert np.abs(np.asarray(jax_reuse[1]) -
                  np.asarray(jax_fresh[1])).max() > 1e-3


# ---- the engine ----------------------------------------------------------

def _engines(d=3, **kw):
    """(JAX LLM, port LLM) on tinycode-llama in float32 with an NGram
    drafter of ``d`` drafts: their engines take G = d + 1 logits rows."""
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu.llmapi.llm_args import SpeculativeConfig as JSC
    args = dict(model=str(CKPT), skip_tokenizer_init=True, dtype="float32",
                max_batch_size=6, max_input_len=64, max_seq_len=128,
                max_num_tokens=256)
    args.update(kw)
    j = J.LLM(**args, enable_warmup=False,
              speculative_config=JSC(mode="NGRAM", max_draft_len=d),
              kv_cache_config=J.KvCacheConfig(tokens_per_block=16,
                                              max_tokens=2048))
    t = T.LLM(**args, device="cpu",
              speculative_config=T.SpeculativeConfig(mode="NGRAM",
                                                     max_draft_len=d),
              kv_cache_config=T.KvCacheConfig(tokens_per_block=16,
                                              max_tokens=2048))
    return j, t


@pytest.fixture(scope="module")
def engines():
    j, t = _engines()
    yield j, t
    j.shutdown()
    t.shutdown()


def _batch(pkg, specs):
    """A scheduled batch of each package from (kind, tokens, state)
    specs: context rows mid-prompt or at its last chunk, generation rows
    with a host-known or device-held input token and drafts."""
    if pkg == "jax":
        from tensorrt_llm_tpu.runtime.request import (LlmRequest,
                                                      LlmRequestState)
        from tensorrt_llm_tpu.runtime.scheduler import ScheduledRequests
        SP = JSP
    else:
        from tensorrt_llm_tpu_torch.runtime.request import (LlmRequest,
                                                            LlmRequestState)
        from tensorrt_llm_tpu_torch.runtime.scheduler import \
            ScheduledRequests
        SP = TSP
    b = ScheduledRequests()
    for i, s in enumerate(specs):
        r = LlmRequest(list(s["prompt"]), SP(**s.get("sp", dict(top_k=1))),
                       request_id=100 + i)
        r.seq_slot = s["slot"]
        r.kv_block_ids = list(s["blocks"])
        if s["kind"] == "ctx":
            r.context_current_position = s["start"]
            r.context_chunk_size = s["chunk"]
            b.context_requests.append(r)
        else:
            r.state = LlmRequestState.GENERATION_IN_PROGRESS
            r.output_token_ids = list(s["out"])
            r.num_device_tokens = s["pos"]
            r.host_token_override = s.get("override")
            r.draft_tokens = list(s["drafts"])
            b.generation_requests.append(r)
    return b


_SPECS = [
    dict(kind="ctx", prompt=range(3, 40), slot=4, blocks=[9, 10, 11],
         start=16, chunk=16),
    dict(kind="ctx", prompt=range(5, 20), slot=2, blocks=[12], start=0,
         chunk=15),
    dict(kind="gen", prompt=range(7, 30), out=[1, 2], slot=0,
         blocks=[0, 1], pos=24, override=44, drafts=[5, 6, 7]),
    dict(kind="gen", prompt=range(8, 38), out=[3], slot=1, blocks=[2, 3],
         pos=30, drafts=[]),
    dict(kind="gen", prompt=range(9, 20), out=[4, 5, 6], slot=3,
         blocks=[4, 5], pos=13, override=9, drafts=[8]),
    dict(kind="gen", prompt=range(10, 26), out=[7], slot=5,
         blocks=[6, 7, 8], pos=31, override=3, drafts=[1, 2]),
]


def test_prepare_inputs_with_drafts_matches_jax(engines):
    """Field by field: drafts behind the input token at the next
    positions and slots (across a page boundary), kv_lens counting them,
    G logits rows per sequence padded by repeating the last, context rows
    filling their G rows; draft_ids as the JAX step packs them
    (model_engine.py:1662-1668)."""
    j, t = engines
    ji = j.engine.prepare_inputs(_batch("jax", _SPECS))
    ti = t.engine.prepare_inputs(_batch("torch", _SPECS))
    for f in ("token_ids", "prev_slot", "positions", "kv_lens",
              "page_indices", "cu_q_lens", "num_seqs", "slot_mapping",
              "logits_indices", "out_slots"):
        np.testing.assert_array_equal(getattr(ti, f), getattr(ji, f),
                                      err_msg=f)
    assert (ti.num_tokens, ti.num_reqs) == (ji.num_tokens, ji.num_reqs)
    G = 4
    want = np.full(6 * G, -1, np.int32)
    for i, s in enumerate(_SPECS):
        if s["kind"] == "gen":
            want[i * G:i * G + len(s["drafts"])] = s["drafts"]
    np.testing.assert_array_equal(ti.draft_ids, want)
    assert ti.max_q_len == 16 and ti.has_prompt
    assert ti.max_kv_len == int(ji.kv_lens.max())


def _step(llm, specs, pkg):
    b = _batch(pkg, specs)
    out = llm.engine.forward_step(b)
    return np.asarray(out[0]), np.asarray(out[1])


def _prefill(j, t, specs):
    """Write the prompts' KV in both engines (one context step each)."""
    for llm, pkg in ((j, "jax"), (t, "torch")):
        _step(llm, specs, pkg)


@pytest.mark.parametrize("sampled", [False, True])
def test_verify_step_matches_jax(engines, sampled):
    """A verify step after a prefill step, in both engines from the same
    KV: greedy rows, and with ``sampled`` sampled rows whose top-p keeps
    one token, one of them seeded (each logits row then verifies by
    ``rejection_sample``: an argmax draft is accepted, any other rejected
    and the residual's argmax drawn, whatever the noise). Tokens exact,
    logprobs within 1e-5, on the live rows."""
    j, t = engines
    prompts = [list(range(3 + 2 * i, 30 + 3 * i)) for i in range(3)]
    blocks = [[2 * i, 2 * i + 1, 20 + i] for i in range(3)]
    ctx = [dict(kind="ctx", prompt=p, slot=i, blocks=b, start=0,
                chunk=len(p)) for i, (p, b) in enumerate(zip(prompts,
                                                              blocks))]
    _prefill(j, t, ctx)
    # the first output of each prompt, from the port's prefill step
    first = _step(t, ctx, "torch")[0].reshape(-1, 4)[:3, 0]
    sps = [dict(temperature=0.8, top_p=1e-6, seed=11 * i) if sampled
           else dict(top_k=1) for i in range(3)]
    sps[1] = dict(top_k=1)
    gen = [dict(kind="gen", prompt=p, out=[int(f)], slot=i, blocks=b,
                pos=len(p), override=int(f), drafts=d, sp=sps[i])
           for i, (p, b, f, d) in enumerate(zip(
               prompts, blocks, first, ([int(first[0]), 1, 2], [7],
                                        [3, 4, 5])))]
    jt, jl = _step(j, gen, "jax")
    tt, tl = _step(t, gen, "torch")
    assert tt.shape == (6 * 4,)
    np.testing.assert_array_equal(tt[:12], jt[:12])
    np.testing.assert_allclose(tl[:12], jl[:12], atol=ATOL)


def test_seeded_rows_sample_at_pos_base(engines):
    """Seeded sampled rows of a verify step draw logits row g at position
    kv_lens - drafts + g (input at p: p + 1 + g), the kv_lens of the step
    without drafts that samples that token, so a seeded stream does not
    depend on the drafts. The step's tokens equal the port's ``sample``
    on the step's own logits rows at those positions."""
    from tensorrt_llm_tpu_torch.ops import sampling_ops as so
    j, t = engines
    eng = t.engine
    p = list(range(4, 33))
    blocks = [30, 31, 32]
    _step(t, [dict(kind="ctx", prompt=p, slot=0, blocks=blocks, start=0,
                   chunk=len(p))], "torch")
    sp = dict(temperature=0.9, top_k=0, top_p=0.95, seed=4242)
    gen = [dict(kind="gen", prompt=p, out=[9], slot=0, blocks=blocks,
                pos=len(p), override=9, drafts=[1, 2, 3], sp=sp)]
    captured = {}
    real = eng._forward

    def spy(tokens, metadata, collect_hidden=False):
        captured["logits"] = real(tokens, metadata, collect_hidden)
        return captured["logits"]
    eng._forward = spy
    try:
        tok = _step(t, gen, "torch")[0]
    finally:
        eng._forward = real
    logits = captured["logits"][:4]
    st = so.SamplingTensors.from_rows(*[torch.as_tensor(a) for a in
                                        so.SamplingTensors.rows(
                                            _batch("torch", gen)
                                            .generation_requests, 1)])
    pos = torch.arange(len(p) + 1, len(p) + 5, dtype=torch.int32)
    want, _ = so.sample(logits, st.repeat_rows(4), None, row_seeds=(
        torch.full((4,), 4242, dtype=torch.int32), pos))
    np.testing.assert_array_equal(tok[:4], want.numpy())


# ---- refusals ------------------------------------------------------------

class _TreeDrafter:
    max_draft_len = 2

    def prepare_draft_tokens(self, requests):
        for r in requests:
            r.draft_tokens = [1, 2]
            r.draft_parents = [-1, -1]

    def update(self, request, accepted):
        pass


def _tiny(**kw):
    from transformers import LlamaConfig

    import tensorrt_llm_tpu_torch as T
    cfg = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256)
    return T.LLM(cfg, device="cpu", dtype="float32", skip_tokenizer_init=True,
                 max_batch_size=4, max_input_len=32, max_seq_len=96,
                 max_num_tokens=128,
                 kv_cache_config=T.KvCacheConfig(tokens_per_block=16,
                                                 max_tokens=1024), **kw)


@pytest.mark.parametrize("kw,name", [
    (dict(mode="EAGLE3", device_window=False, eagle_tree_width=2),
     "eagle_tree_width"),
    (dict(mode="DFLASH"), "DFLASH"),
    (dict(mode="MTP", device_window=False, eagle_dynamic_tree=True),
     "eagle_dynamic_tree"),
    (dict(mode="NGRAM", eagle_tree_width=2), "eagle_tree_width"),
    (dict(mode="DRAFT_TARGET", eagle_dynamic_tree=True),
     "eagle_dynamic_tree"),
])
def test_what_stays_refused_by_name(kw, name):
    from tensorrt_llm_tpu_torch import LlmArgs, SpeculativeConfig
    with pytest.raises(NotImplementedError, match=name):
        LlmArgs(model="m", speculative_config=SpeculativeConfig(
            max_draft_len=2, **kw))


def test_tree_drafts_refused_by_name():
    """A user's drafter that sets draft_parents (tree drafts): the request
    fails by name, as no tree verify is ported."""
    import tensorrt_llm_tpu_torch as T
    llm = _tiny(speculative_config=T.SpeculativeConfig(
        mode="USER_PROVIDED", max_draft_len=2, draft_model=_TreeDrafter()))
    try:
        with pytest.raises(NotImplementedError, match="draft_parents"):
            llm.generate([5, 6, 7], T.SamplingParams(max_tokens=4))
    finally:
        llm.shutdown()


@pytest.mark.parametrize("kw,match", [
    (dict(mode="USER_PROVIDED"), "USER_PROVIDED needs a Drafter"),
    (dict(mode="DRAFT_TARGET"), "needs speculative_config.draft_model"),
    (dict(mode="PARD", draft_model="__config__"), "mask"),
])
def test_host_modes_need_their_drafter(kw, match):
    from transformers import LlamaConfig

    import tensorrt_llm_tpu_torch as T
    if kw.get("draft_model") == "__config__":
        kw["draft_model"] = LlamaConfig(
            vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=2,
            num_key_value_heads=2)
    with pytest.raises(ValueError, match=match):
        _tiny(speculative_config=T.SpeculativeConfig(max_draft_len=2, **kw))
