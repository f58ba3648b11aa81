"""Guided decoding in the port against the JAX package on the CPU: the
counterparts of tests/test_guided.py and tests/test_guided_device.py.

- the compilers (``compile_regex``, ``schema_to_regex``,
  ``json_object_regex``, ``ebnf_to_regex``, the structural-tag DFA,
  ``build_token_dfa`` on a decimal and a byte table) give the JAX
  package's strings and arrays exactly; ``TokenTable.from_tokenizer``
  equals the JAX one on a tokenizer built in memory;
- through ``LLM.generate`` on tests/assets/tinycode-llama in float32
  (byte table, ``end_id=0``), greedy tokens equal the JAX ``LLM``'s,
  exactly, for every grammar kind: the device backend on the overlap
  scheduler with K-step windows, the host backend on the sync one, and a
  mixed batch with unguided rows;
- the pool and slots: segment sharing and release, ``state_after``, an
  oversize grammar failing alone, a full pool deferring, a recycled slot
  unmasked, a paused request resuming its grammar, the slot's state
  after a window equal to the host's walk;
- a masked row sampled at temperature 0.5 with a repetition penalty
  gives no NaN;
- the refusals by name, and the JAX package's behaviour where the port
  refuses (each recorded in ROADMAP C).

Both packages' pools hold 16,384 states here: ``json_object_regex()``
compiles to 10,976 DFA states, more than the default 8,192.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

CKPT = str(Path(__file__).parent / "assets" / "tinycode-llama")
PROMPTS = [list(b"def forward(self, x):\n    return "),
           list(b'{"name": '), list(b"x = 1\ny = ")]
SCHEMA = {"type": "object",
          "properties": {"name": {"type": "string"},
                         "age": {"type": "integer"},
                         "color": {"type": "string",
                                   "enum": ["red", "green", "blue"]},
                         "ids": {"type": "array",
                                 "items": {"type": "integer"},
                                 "maxItems": 8}},
          "required": ["name", "age", "color", "ids"]}
EBNF = """root ::= expr
expr ::= num | num op expr | "(" expr ")" | "(" expr ")" op expr
num ::= [0-9]+
op ::= [-+*/]
"""
STRUCT = json.dumps({"structures": [{"begin": "<f>",
                                     "content_regex": "[0-9]+",
                                     "end": "</f>"}],
                     "triggers": ["<f>"]})
KINDS = {"regex": dict(regex=r"\d{3}-\d{4}"), "json": dict(json=SCHEMA),
         "json_object": dict(json_object=True), "ebnf": dict(grammar=EBNF),
         "structural": dict(structural_tag=STRUCT)}
REGEXES = ["abc", "a+b*", "(foo|bar)+", "[a-c]{2,3}", "-?[0-9]+(\\.[0-9]+)?",
           "a{3}", "x{0,2}", r"\d{3}-\d{4}", r"[^\n]{1,5}\x41", r"\w+\s\S"]


@pytest.fixture(scope="module", autouse=True)
def _pool():
    old = os.environ.get("TLLM_TPU_GUIDED_POOL_STATES")
    os.environ["TLLM_TPU_GUIDED_POOL_STATES"] = "16384"
    yield
    if old is None:
        os.environ.pop("TLLM_TPU_GUIDED_POOL_STATES", None)
    else:
        os.environ["TLLM_TPU_GUIDED_POOL_STATES"] = old


def _kw(backend, K=8, **extra):
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=96, max_seq_len=200, max_num_tokens=256,
              decode_multi_step=K, guided_decoding_backend=backend,
              guided_token_bytes="byte",
              disable_overlap_scheduler=backend == "dfa-host")
    kw.update(extra)
    return kw


def _pair(backend, K=8):
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    j = J.LLM(model=CKPT, kv_cache_config=J.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048), **_kw(backend, K))
    t = T.LLM(CKPT, device="cpu", kv_cache_config=T.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048), **_kw(backend, K))
    return j, t


@pytest.fixture(scope="module")
def device_pair():
    j, t = _pair("dfa")
    yield j, t
    j.shutdown()
    t.shutdown()


@pytest.fixture(scope="module")
def host_pair():
    j, t = _pair("dfa-host", K=1)
    yield j, t
    j.shutdown()
    t.shutdown()


def _sp(pkg, kind=None, **kw):
    if pkg == "jax":
        from tensorrt_llm_tpu import GuidedDecodingParams, SamplingParams
    else:
        from tensorrt_llm_tpu_torch import GuidedDecodingParams, SamplingParams
    gd = GuidedDecodingParams(**KINDS[kind]) if kind else None
    base = dict(max_tokens=32, top_k=1, end_id=0, ignore_eos=kind is None,
                guided_decoding=gd)
    base.update(kw)
    return SamplingParams(**base)


def _tokens(llm, pkg, prompts, kinds):
    futs = [llm.generate_async(p, _sp(pkg, k)) for p, k in zip(prompts,
                                                                 kinds)]
    return [f.result(timeout=300).outputs[0].token_ids for f in futs]


def _alive(tokens, kind, accepted_if_eos=True):
    """The byte walk of ``tokens`` (to the first EOS, token 0) never dies
    in the grammar's DFA, and ends accepting when it ended on EOS."""
    from tensorrt_llm_tpu_torch import GuidedDecodingParams
    from tensorrt_llm_tpu_torch.guided.grammar_matcher import (MatcherFactory,
                                                               TokenTable)
    f = MatcherFactory(TokenTable([bytes([i]) for i in range(256)], 0))
    _, dfa = f.compile_dfa(GuidedDecodingParams(**KINDS[kind]))
    s = dfa.start
    eos = 0 in tokens
    for t in tokens[:tokens.index(0) if eos else len(tokens)]:
        if t >= 256 or int(dfa.table[s, t]) < 0:
            return False
        s = int(dfa.table[s, t])
    return bool(dfa.accepting[s]) or not (eos and accepted_if_eos)


# ---- the compilers --------------------------------------------------------

def _dfa_pair(fn_name, *args, **kw):
    from tensorrt_llm_tpu.guided import regex_dfa as jr
    from tensorrt_llm_tpu_torch.guided import regex_dfa as tr
    return getattr(jr, fn_name)(*args, **kw), getattr(tr, fn_name)(*args,
                                                                   **kw)


def _same_dfa(a, b):
    np.testing.assert_array_equal(a.table, b.table)
    np.testing.assert_array_equal(a.accepting, b.accepting)
    assert a.start == b.start


@pytest.mark.parametrize("pattern", REGEXES)
def test_compile_regex_matches_jax(pattern):
    """Tables, accepting sets and start states equal the JAX compiler's."""
    _same_dfa(*_dfa_pair("compile_regex", pattern))


@pytest.mark.parametrize("schema", [
    SCHEMA,
    {"type": "object", "properties": {"name": {"type": "string"},
                                      "age": {"type": "integer"}},
     "required": ["name", "age"]},
    {"enum": [1, "a", None]},
    {"type": "array", "items": {"type": "number"}, "minItems": 1},
    {"type": "object", "properties": {"o": {"type": "object",
                                            "properties": {
                                                "b": {"type": "boolean"}}},
                                      "n": {"type": "null"}}},
    {"type": "string"}])
def test_schema_to_regex_matches_jax(schema):
    from tensorrt_llm_tpu.guided.grammar_matcher import schema_to_regex as j
    from tensorrt_llm_tpu_torch.guided.grammar_matcher import (
        schema_to_regex as t)
    assert t(schema) == j(schema)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_json_regexes_match_jax(depth):
    from tensorrt_llm_tpu.guided import grammar_matcher as jg
    from tensorrt_llm_tpu_torch.guided import grammar_matcher as tg
    assert tg.json_object_regex(depth) == jg.json_object_regex(depth)
    assert tg.json_value_regex(depth) == jg.json_value_regex(depth)


@pytest.mark.parametrize("grammar,depth", [
    ('root ::= "yes" | "no" | "maybe"', 6),
    ('# a list\nroot ::= word ("," ws word)*\nword ::= [a-z]+\n'
     'ws ::= [ ]?', 6),
    ('root ::= "()" | "(" root ")"', 4),
    (EBNF, 6),
    ('root ::= "a\\"b" [^x]+ ("c" | "d")?', 6)])
def test_ebnf_to_regex_matches_jax(grammar, depth):
    from tensorrt_llm_tpu.guided.ebnf import ebnf_to_regex as j
    from tensorrt_llm_tpu_torch.guided.ebnf import ebnf_to_regex as t
    assert t(grammar, max_depth=depth) == j(grammar, max_depth=depth)


def test_ebnf_recursion_error_matches_jax():
    from tensorrt_llm_tpu.guided.ebnf import ebnf_to_regex as j
    from tensorrt_llm_tpu_torch.guided.ebnf import ebnf_to_regex as t
    for fn in (j, t):
        with pytest.raises(ValueError, match="recursion"):
            fn('root ::= "(" root ")"', max_depth=2)


def test_structural_dfa_matches_jax():
    structures = [("<f>", "[0-9]+", "</f>"), ("{", None, "}"),
                  ("<json>", r"\{\}", "</json>")]
    _same_dfa(*_dfa_pair("build_structural_dfa", structures))


@pytest.mark.parametrize("table", ["decimal", "byte"])
@pytest.mark.parametrize("kind", ["regex", "json", "ebnf", "structural"])
def test_build_token_dfa_matches_jax(table, kind):
    """``build_token_dfa`` over a decimal table (token i is str(i)) and a
    byte table (token i < 256 is byte i, the rest empty) of 300 tokens:
    the transitions and EOS flags equal the JAX build's."""
    from tensorrt_llm_tpu.guided import grammar_matcher as jg
    from tensorrt_llm_tpu.guided.token_dfa import build_token_dfa as jb
    from tensorrt_llm_tpu.sampling_params import GuidedDecodingParams as JP
    from tensorrt_llm_tpu_torch.guided import grammar_matcher as tg
    from tensorrt_llm_tpu_torch.guided.token_dfa import build_token_dfa as tb
    from tensorrt_llm_tpu_torch.sampling_params import (
        GuidedDecodingParams as TP)
    V = 300
    strs = [str(i) for i in range(V)] if table == "decimal" else \
        [bytes([i]) for i in range(256)] + [b""] * (V - 256)
    outs = []
    for g, build, P in ((jg, jb, JP), (tg, tb, TP)):
        tt = g.TokenTable(strs, eos_token_id=0)
        _, dfa = g.MatcherFactory(tt).compile_dfa(P(**KINDS[kind]))
        outs.append(build(dfa, tt.token_bytes, tt.token_lens, 0,
                          vocab_size=V + 4, state_block=64))
    np.testing.assert_array_equal(outs[0].trans, outs[1].trans)
    np.testing.assert_array_equal(outs[0].eos_ok, outs[1].eos_ok)
    assert outs[0].start == outs[1].start


def test_token_table_from_tokenizer_matches_jax():
    """A byte-level BPE tokenizer built in memory (no download): the
    tables' bytes, lengths and EOS id equal the JAX package's."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    from tensorrt_llm_tpu.guided.grammar_matcher import TokenTable as JT
    from tensorrt_llm_tpu_torch.guided.grammar_matcher import TokenTable as TT
    alphabet = pre_tokenizers.ByteLevel.alphabet()
    vocab = {c: i for i, c in enumerate(sorted(alphabet))}
    for extra in ("Ġthe", "in", "Ġa", "Ġ{", "\"name"):
        vocab[extra] = len(vocab)
    vocab["</s>"] = len(vocab)
    merges = [("Ġ", "t"), ("Ġt", "h"), ("Ġth", "e"), ("i", "n"),
              ("Ġ", "a"), ("Ġ", "{")]
    vocab.update({"Ġt": len(vocab), "Ġth": len(vocab) + 1})
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    hf = PreTrainedTokenizerFast(tokenizer_object=tok, eos_token="</s>")
    j, t = JT.from_tokenizer(hf), TT.from_tokenizer(hf)
    np.testing.assert_array_equal(j.token_bytes, t.token_bytes)
    np.testing.assert_array_equal(j.token_lens, t.token_lens)
    assert (j.eos_token_id, j.vocab_size) == (t.eos_token_id, t.vocab_size)
    assert t.eos_token_id == vocab["</s>"]


def test_host_matcher_masks_match_jax():
    """The host matchers' masks and states along one walk, rollback
    included, equal the JAX matchers'."""
    from tensorrt_llm_tpu.guided.grammar_matcher import (MatcherFactory as JF,
                                                         TokenTable as JT)
    from tensorrt_llm_tpu.sampling_params import GuidedDecodingParams as JP
    from tensorrt_llm_tpu_torch.guided.grammar_matcher import (
        MatcherFactory as TF, TokenTable as TT)
    from tensorrt_llm_tpu_torch.sampling_params import (
        GuidedDecodingParams as TP)
    strs = [bytes([i]) for i in range(256)]
    mj = JF(JT(strs, 0)).create(JP(json=SCHEMA))
    mt = TF(TT(strs, 0)).create(TP(json=SCHEMA))
    for b in b'{"name": "x", "age": 12':
        np.testing.assert_array_equal(mj.fill_next_token_bitmask(),
                                      mt.fill_next_token_bitmask())
        assert mj.accept_token(b) == mt.accept_token(b)
        assert mj.state == mt.state
    mj.rollback(3)
    mt.rollback(3)
    assert mj.state == mt.state
    assert mj.is_terminated() == mt.is_terminated()


# ---- the port's LLM against the JAX LLM ------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_device_backend_matches_jax(device_pair, kind):
    """The device backend on the overlap scheduler (K = 8): the grammar
    masks and walks on the device in single steps and windows; tokens
    equal the JAX device backend's, and each output is a live prefix of
    its grammar (accepted where it ended on EOS)."""
    j, t = device_pair
    w0 = t.engine.guided_windows
    want = _tokens(j, "jax", PROMPTS, [kind] * 3)
    got = _tokens(t, "torch", PROMPTS, [kind] * 3)
    assert got == want
    assert all(_alive(x, kind) for x in got)
    assert t.executor.enable_overlap
    if kind in ("json", "structural"):       # long enough to open windows
        assert t.engine.guided_windows > w0


@pytest.mark.parametrize("kind", list(KINDS))
def test_host_backend_matches_jax_and_device(host_pair, device_pair, kind):
    """The host backend (``dfa-host``, the sync scheduler, one [S, V]
    mask per step): tokens equal the JAX host backend's and the device
    backend's."""
    j, t = host_pair
    want = _tokens(j, "jax", PROMPTS, [kind] * 3)
    got = _tokens(t, "torch", PROMPTS, [kind] * 3)
    assert got == want
    assert got == _tokens(device_pair[1], "torch", PROMPTS, [kind] * 3)
    assert not t.executor.enable_overlap


@pytest.mark.parametrize("backend", ["dfa", "dfa-host"])
def test_mixed_batch_matches_jax(device_pair, host_pair, backend):
    """Guided and unguided rows in one batch: every row's tokens equal the
    JAX package's (the unguided rows unmasked)."""
    j, t = device_pair if backend == "dfa" else host_pair
    kinds = ["regex", None, "json", None]
    prompts = PROMPTS + [list(b"import numpy as np\n")]
    want = _tokens(j, "jax", prompts, kinds)
    assert _tokens(t, "torch", prompts, kinds) == want


# ---- pool and slots ---------------------------------------------------------

def test_segment_sharing_and_release(device_pair):
    """Concurrent requests with one grammar share one segment; finished,
    its refcount is 0, and the grammar's next request reuses it; every
    slot's state is -1 again."""
    t = device_pair[1]
    mgr = t.executor.guided_decoder.device
    key = mgr.factory.compile_dfa(
        _sp("torch", "regex").guided_decoding)[0]
    _tokens(t, "torch", PROMPTS, ["regex"] * 3)
    seg = mgr._segments[key]
    assert seg.refs == 0
    base = seg.base
    _tokens(t, "torch", PROMPTS[:1], ["regex"])
    assert mgr._segments[key].base == base and mgr._segments[key].refs == 0
    assert (t.engine.g_state == -1).all()


def test_state_after_resume_replay(device_pair):
    """``state_after`` replays output tokens from the start state; a token
    the grammar refuses gives -1."""
    from tensorrt_llm_tpu_torch import GuidedDecodingParams
    mgr = device_pair[1].executor.guided_decoder.device
    gp = GuidedDecodingParams(regex="123")
    mgr.acquire(gp)
    try:
        s0 = mgr.state_after(gp, [])
        s1 = mgr.state_after(gp, list(b"1"))
        s2 = mgr.state_after(gp, list(b"12"))
        assert len({s0, s1, s2}) == 3 and min(s0, s1, s2) >= 0
        assert mgr.state_after(gp, list(b"9")) == -1
        assert mgr.state_after(gp, list(b"12") + [0, 57]) == s2  # EOS ends
    finally:
        mgr.release(gp)


def test_oversize_grammar_fails_alone(device_pair):
    """A grammar that can never fit the pool fails its request alone, with
    an error naming the pool, while a request beside it finishes; the
    JAX package fails it the same way."""
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    j, t = device_pair
    big = "[0-9]{20000}"
    for llm, pkg in ((t, T), (j, J)):
        ok = llm.generate_async(PROMPTS[0], _sp(
            "torch" if pkg is T else "jax", "regex"))
        bad = llm.generate_async(PROMPTS[1], pkg.SamplingParams(
            max_tokens=8, top_k=1, end_id=0,
            guided_decoding=pkg.GuidedDecodingParams(regex=big)))
        with pytest.raises(ValueError, match="pool"):
            bad.result(timeout=300)
        assert _alive(ok.result(timeout=300).outputs[0].token_ids, "regex")
    ex = t.executor
    assert all(r.request_id != bad.request_id for r in ex._active)


def test_full_pool_defers():
    """A pool of two 256-state blocks and three requests with three small
    grammars submitted at once: the third waits (``NoPoolSpaceError``
    defers it) until a segment is free, and every request returns what
    it returns alone."""
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.guided.device_guided import (
        DeviceGuidedManager, NoPoolSpaceError)
    os.environ["TLLM_TPU_GUIDED_POOL_STATES"] = "512"
    try:
        llm = T.LLM(CKPT, device="cpu", kv_cache_config=T.KvCacheConfig(
            tokens_per_block=16, max_tokens=2048), **_kw("dfa"))
    finally:
        os.environ["TLLM_TPU_GUIDED_POOL_STATES"] = "16384"
    gps = [T.GuidedDecodingParams(regex=r) for r in
           (r"[a-z]{4,12}", r"\d{2,6}", r"[A-Z_]{3,9}")]
    sps = [T.SamplingParams(max_tokens=16, top_k=1, end_id=0,
                            guided_decoding=g) for g in gps]
    try:
        mgr = llm.executor.guided_decoder.device
        assert isinstance(mgr, DeviceGuidedManager)
        alone = [llm.generate(p, s).outputs[0].token_ids
                 for p, s in zip(PROMPTS, sps)]
        # the cached segments are not held: a full pool evicts them
        mgr._evict_unreferenced()
        mgr.acquire(gps[0])
        mgr.acquire(gps[1])
        with pytest.raises(NoPoolSpaceError):
            mgr.acquire(gps[2])
        mgr.release(gps[0])
        mgr.release(gps[1])
        d0 = llm.executor.guided_deferred
        futs = [llm.generate_async(p, s) for p, s in zip(PROMPTS, sps)]
        assert [f.result(timeout=300).outputs[0].token_ids
                for f in futs] == alone
        assert llm.executor.guided_deferred > d0
    finally:
        llm.shutdown()


def test_recycled_slot_is_unmasked(device_pair):
    """An unguided request that takes the slot a guided request held
    returns the JAX package's unguided tokens."""
    j, t = device_pair
    _tokens(t, "torch", PROMPTS[:1], ["json"])
    slot = t.executor._free_slots[-1]           # the next slot taken
    assert t.engine.g_state[slot] == -1
    want = _tokens(j, "jax", PROMPTS[2:], [None])
    assert _tokens(t, "torch", PROMPTS[2:], [None]) == want


def test_pause_resume_keeps_grammar():
    """Under MAX_UTILIZATION with a small KV pool, guided requests are
    paused and resumed (recomputing their tokens): each resumed slot's
    state is replayed past its tokens (``state_after``), so the outputs
    equal those of a pool large enough for no pause."""
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu_torch.llmapi.llm_args import SchedulerConfig
    from tensorrt_llm_tpu_torch.runtime.scheduler import \
        CapacitySchedulerPolicy
    sps = [_sp("torch", k, max_tokens=60) for k in ("json", "structural",
                                                    "json")]
    prompts = [PROMPTS[0], PROMPTS[2], PROMPTS[1]]
    outs, pauses = {}, {}
    for tokens in (2048, 160):
        llm = T.LLM(CKPT, device="cpu", scheduler_config=SchedulerConfig(
            capacity_scheduler_policy=CapacitySchedulerPolicy
            .MAX_UTILIZATION), kv_cache_config=T.KvCacheConfig(
                tokens_per_block=16, max_tokens=tokens), **_kw("dfa"))
        ex = llm.executor
        n = [0]
        pause = ex._pause_requests

        def counted(paused, batch):
            n[0] += sum(not r.is_finished for r in paused)
            pause(paused, batch)
        ex._pause_requests = counted
        try:
            futs = [llm.generate_async(p, s) for p, s in zip(prompts, sps)]
            outs[tokens] = [f.result(timeout=300).outputs[0].token_ids
                            for f in futs]
            pauses[tokens] = n[0]
        finally:
            llm.shutdown()
    assert pauses[160] > 0 and pauses[2048] == 0
    assert outs[160] == outs[2048]


def test_slot_state_after_window_equals_host_walk(device_pair):
    """After a request's last window (17 tokens: the prefill step's and
    two windows of K = 8, each of whose tokens the host keeps; the
    grammar never accepting, so no EOS), its slot's state equals the
    host's ``state_after`` over its tokens."""
    from tensorrt_llm_tpu_torch import GuidedDecodingParams, SamplingParams
    t = device_pair[1]
    ex = t.executor
    seen = {}
    finish = ex._finish_request

    def record(req):
        if req.seq_slot is not None and req.guided_device:
            seen[req.request_id] = (int(t.engine.g_state[req.seq_slot]),
                                    list(req.output_token_ids))
        finish(req)
    gp = GuidedDecodingParams(regex="[a-z ]{40}")
    ex._finish_request = record
    try:
        out = t.generate(list(b"the quick brown fox "), SamplingParams(
            max_tokens=17, top_k=1, end_id=0, guided_decoding=gp))
    finally:
        ex._finish_request = finish
    state, toks = seen[out.request_id]
    assert toks == out.outputs[0].token_ids and len(toks) == 17
    assert state == ex.guided_decoder.device.state_after(gp, toks) >= 0


# ---- sampling ----------------------------------------------------------------

def test_masked_row_sampling_has_no_nan():
    """The grammar mask's float32 minimum, divided by a temperature of 0.5
    and multiplied by a repetition penalty, overflows to -inf: the sampler
    still gives such tokens no probability, and finite logprobs."""
    from tensorrt_llm_tpu_torch.ops.sampling_ops import SamplingTensors, sample
    from tensorrt_llm_tpu_torch.sampling_params import SamplingParams
    from tensorrt_llm_tpu_torch.runtime.request import LlmRequest
    g = torch.Generator().manual_seed(0)
    V, R = 64, 6
    logits = torch.randn((R, V), generator=g)
    allowed = torch.rand((R, V), generator=g) < 0.2
    allowed[:, 5] = True
    logits = torch.where(allowed, logits, torch.finfo(torch.float32).min)
    reqs = [LlmRequest([1], SamplingParams(temperature=0.5,
                                           repetition_penalty=1.3,
                                           top_p=0.9, seed=i + 1))
            for i in range(R)]
    ints, floats = SamplingTensors.rows(reqs, R)
    st = SamplingTensors.from_rows(torch.as_tensor(ints),
                                   torch.as_tensor(floats))
    counts = (torch.rand((R, V), generator=g) < 0.5).int()
    for _ in range(20):
        tok, lp = sample(logits, st, g, token_counts=counts)
        assert allowed[torch.arange(R), tok].all()
        assert torch.isfinite(lp).all()


def test_guided_sampled_rows_stay_in_grammar(device_pair):
    """Seeded sampled guided rows at temperature 0.5 with a repetition
    penalty, in windows: live prefixes of their grammar, finite
    logprobs."""
    t = device_pair[1]
    outs = t.generate(PROMPTS, _sp("torch", "json", temperature=0.5,
                                   top_k=0, repetition_penalty=1.3,
                                   seed=7))
    for o in outs:
        assert _alive(o.outputs[0].token_ids, "json")
        assert all(np.isfinite(list(d.values())[0])
                   for d in o.outputs[0].logprobs)


# ---- refusals, and the JAX package's behaviour there ---------------------

def test_refused_without_backend():
    """A guided request on an LLM without a guided backend is refused,
    naming the knob; the JAX LLM serves it unconstrained (no decoder
    exists)."""
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    kw = _kw(None, K=1)
    t = T.LLM(CKPT, device="cpu", kv_cache_config=T.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048), **kw)
    try:
        with pytest.raises(ValueError, match="guided_decoding_backend"):
            t.generate(PROMPTS[0], _sp("torch", "regex"))
    finally:
        t.shutdown()
    j = J.LLM(model=CKPT, kv_cache_config=J.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048), **kw)
    try:
        toks = j.generate(PROMPTS[0], _sp("jax", "regex")).outputs[0] \
            .token_ids
    finally:
        j.shutdown()
    assert not _alive(toks, "regex")


def test_refused_with_beam_search():
    """Guided decoding with beam search is refused by name; the JAX
    package's beam rows carry no grammar (``make_beam_rows`` builds their
    SamplingParams without it), so its beams are unconstrained."""
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu.runtime.beam_search import make_beam_rows
    from tensorrt_llm_tpu.runtime.request import LlmRequest
    kw = _kw("dfa-host", K=1, max_beam_width=4)
    t = T.LLM(CKPT, device="cpu", kv_cache_config=T.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048), **kw)
    sp = dict(use_beam_search=True, best_of=4, top_k=0)
    try:
        with pytest.raises(NotImplementedError, match="beam search"):
            t.generate(PROMPTS[0], _sp("torch", "regex", **sp))
    finally:
        t.shutdown()
    rows = make_beam_rows(LlmRequest(PROMPTS[0], _sp("jax", "regex", **sp)))
    assert all(r.sampling_params.guided_decoding is None for r in rows)


def test_refused_with_speculation_and_jax_unmasked():
    """Guided decoding with speculative decoding is refused by name. In
    the JAX package a device-guided row of a verify step (G > 1) gets
    neither the device walk nor a host mask, so its output leaves the
    grammar."""
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu.llmapi.llm_args import SpeculativeConfig as JSpec
    spec = dict(mode="NGRAM", max_draft_len=3)
    kw = _kw("dfa", K=1)
    t = T.LLM(CKPT, device="cpu", kv_cache_config=T.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048),
        speculative_config=T.SpeculativeConfig(**spec), **kw)
    try:
        with pytest.raises(NotImplementedError, match="speculative"):
            t.generate(PROMPTS[0], _sp("torch", "regex"))
    finally:
        t.shutdown()
    j = J.LLM(model=CKPT, kv_cache_config=J.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048),
        speculative_config=JSpec(**spec), **kw)
    try:
        toks = [o.outputs[0].token_ids for o in j.generate(
            PROMPTS, _sp("jax", "regex"))]
    finally:
        j.shutdown()
    assert not all(_alive(x, "regex") for x in toks)


def test_reference_grammar_limits():
    """Two limits of the JAX compilers the port keeps: ``json_object``
    needs more DFA states than the default 8,192-state pool, and the JSON
    string grammar admits escapes JSON does not (a backslash before any
    byte)."""
    from tensorrt_llm_tpu.guided.grammar_matcher import (_STRING,
                                                         json_object_regex)
    from tensorrt_llm_tpu.guided.regex_dfa import compile_regex
    assert compile_regex(json_object_regex()).num_states > 8192
    dfa = compile_regex(_STRING)
    s = dfa.start
    for b in b'"\\q"':
        s = int(dfa.table[s, b])
    assert dfa.accepting[s]
    with pytest.raises(json.JSONDecodeError):
        json.loads('"\\q"')
