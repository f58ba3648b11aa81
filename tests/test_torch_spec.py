"""The port's EAGLE3 speculative pieces against the JAX package's, on the
CPU in float32 with the in-repo pair (target tests/assets/tinycode-llama,
head tests/assets/tinycode-eagle): the head's parameters carried across
and its forward (1e-5), the target's collected hidden rows (1e-4, six
layers summed in another order), ``rejection_sample`` (greedy rows, seeded
rows against the port's own ``sample``, unseeded rows by distribution),
one fused window dispatch against JAX ``build_spec_window`` from the same
state (tokens, counts and integer state equal, logprobs within 1e-5, the
pending target features, of magnitude up to 20 after six layers, within
1e-4 + 1e-5 relative, as the collected hidden rows), the static
buffers of a spec window, and the refusals of what is not ported.

Every live catch-up row of the dispatch test sees a key (pos_h >= d+1):
where it does not, the JAX reference attends to the mean of V and the
port's kernels give 0 (runtime/spec_window.py module docstring), so drafts
may differ there while tokens do not."""
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

CKPT = Path(__file__).parent / "assets" / "tinycode-llama"
HEAD = Path(__file__).parent / "assets" / "tinycode-eagle"
ATOL = 1e-5
PS, NP, S, MAX_SEQ = 16, 40, 4, 128


@pytest.fixture(scope="module")
def models():
    from safetensors.numpy import load_file
    from transformers import AutoConfig

    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu.quantization.lazy_state_dict import LazyStateDict
    from tensorrt_llm_tpu_torch.models import ModelConfig as TConfig
    from tensorrt_llm_tpu_torch.models import from_jax_params
    from tensorrt_llm_tpu_torch.models import get_model_class as tget

    cfg = AutoConfig.from_pretrained(CKPT)
    jm = jget("llama")(JConfig(hf_config=cfg, dtype=jnp.float32))
    jparams = jm.load_hf_state_dict(LazyStateDict(CKPT))
    tm = tget("llama")(TConfig(hf_config=cfg, dtype=torch.float32,
                               device="cpu"))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams))
    heads = {"trained": load_file(str(HEAD / "model.safetensors")),
             "random": None}
    return jm, jparams, tm, tparams, heads


def _drafters(models, head, d=3):
    from tensorrt_llm_tpu.speculative.eagle import Eagle3Drafter as JEagle
    from tensorrt_llm_tpu_torch.speculative.eagle import \
        Eagle3Drafter as TEagle
    jm, jparams, tm, tparams, heads = models
    sd = heads[head]
    jd = JEagle(jm, jparams, max_draft_len=d, max_slots=1,
                max_seq_len=MAX_SEQ, head_state_dict=sd)
    td = TEagle(tm, tparams, max_draft_len=d, max_seq_len=MAX_SEQ,
                head_state_dict=None if sd is None else
                {k: torch.from_numpy(v) for k, v in sd.items()})
    return jd, td


def _md(mod, tensor, **kw):
    return mod.AttentionMetadata(**{k: tensor(np.asarray(v, np.int32))
                                    for k, v in kw.items()})


@pytest.mark.parametrize("head", ["trained", "random"])
def test_head_params_and_forward_match_jax(models, head):
    """The head's weights carried across (``head_params_from_jax``) equal
    the port's own load, and one ragged head pass (two sequences of 3 and
    2 rows, every row seeing a key) gives the same features, head KV and
    draft tokens."""
    from tensorrt_llm_tpu.ops import attention as jattn
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    from tensorrt_llm_tpu_torch.speculative.eagle import head_params_from_jax
    jd, td = _drafters(models, head)
    carried = head_params_from_jax(jax.tree.map(np.asarray, jd.params),
                                   torch.float32)
    assert sorted(carried) == sorted(td.params)
    for k, v in carried.items():
        a = v["weight"] if isinstance(v, dict) else v
        b = td.params[k]["weight"] if isinstance(v, dict) else td.params[k]
        assert torch.equal(a, b), k

    rng = np.random.default_rng(1)
    H = td.H
    pool = (rng.standard_normal((8, 32) + td.kv_entry_shape) * 0.5) \
        .astype(np.float32)
    feats = rng.standard_normal((5, H)).astype(np.float32)
    toks = rng.integers(0, 256, 5).astype(np.int32)
    pages = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    pos = np.array([40, 41, 42, 9, 10], np.int32)
    seq = np.array([0, 0, 0, 1, 1])
    md = dict(kv_lens=[43, 11], page_indices=pages, cu_q_lens=[0, 3, 5],
              num_seqs=[2], positions=pos,
              slot_mapping=pages[seq, pos // 32] * 32 + pos % 32,
              logits_indices=[2, 4])
    jh, jpool = jd._head_forward(jd.params, jnp.asarray(feats),
                                 jnp.asarray(toks), jnp.asarray(pool),
                                 _md(jattn, jnp.asarray, **md), jd.embed)
    tpool = torch.from_numpy(pool.copy())
    th = td.head_forward(torch.from_numpy(feats),
                         torch.from_numpy(toks).long(), tpool,
                         _md(tattn, torch.from_numpy, **md))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), atol=ATOL)
    jtok = np.asarray(jnp.argmax(jnp.dot(jh, jd.lm_head["weight"]), -1))
    assert td.draft_argmax(th).tolist() == jtok.tolist()


def test_collected_hidden_rows_match_jax(models):
    """``forward(..., collect_hidden=True)``: the pre-final-norm rows at
    ``logits_indices``, the draft head's features."""
    from tensorrt_llm_tpu.ops import attention as jattn
    from tensorrt_llm_tpu_torch.ops import attention as tattn
    jm, jparams, tm, tparams, _ = models
    toks = np.arange(3, 24, dtype=np.int32)
    pages = np.array([[0, 1]], np.int32)
    md = dict(kv_lens=[21], page_indices=pages, cu_q_lens=[0, 21],
              num_seqs=[1], slot_mapping=np.arange(21),
              positions=np.arange(21), logits_indices=[20])
    _, _, jh = jm.forward(jparams, jnp.asarray(toks), jm.make_kv_pages(4, PS),
                          _md(jattn, jnp.asarray, **md), collect_hidden=True)
    tl, _, th = tm.forward(tparams, torch.from_numpy(toks).long(),
                           tm.make_kv_pages(4, PS),
                           _md(tattn, torch.from_numpy, **md),
                           collect_hidden=True)
    assert th.shape == (1, tm.hidden_size) and tl.shape == (1, 257)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)


# ---- rejection sampling ----------------------------------------------------

def _st(n, greedy=False, temperature=0.7, top_k=0, top_p=1.0):
    from tensorrt_llm_tpu_torch.ops.sampling_ops import SamplingTensors
    full = torch.full
    return SamplingTensors(
        temperature=full((n,), temperature), top_k=full((n,), top_k),
        top_p=full((n,), top_p), min_p=torch.zeros(n),
        greedy=full((n,), greedy), repetition_penalty=torch.ones(n),
        presence_penalty=torch.zeros(n), frequency_penalty=torch.zeros(n))


def test_rejection_sample_greedy_rows_take_the_argmax():
    from tensorrt_llm_tpu_torch.ops.sampling_ops import rejection_sample
    logits = torch.randn(16, 50, generator=torch.Generator().manual_seed(0))
    drafts = torch.arange(16) % 50
    tok, lp = rejection_sample(logits, _st(16, greedy=True),
                               torch.Generator().manual_seed(1), drafts)
    assert torch.equal(tok, logits.argmax(-1))
    np.testing.assert_allclose(
        lp.numpy(), torch.log_softmax(logits / 0.7, -1).gather(
            1, tok[:, None])[:, 0].numpy(), atol=1e-6)


def test_rejection_sample_seeded_rows_equal_the_plain_sample():
    """Sample-and-match: a seeded row emits exactly the token the port's
    non-speculative ``sample`` draws at that (seed, position), whatever
    the draft and the generator."""
    from tensorrt_llm_tpu_torch.ops.sampling_ops import (rejection_sample,
                                                         sample)
    g = torch.Generator().manual_seed(2)
    R, V = 64, 97
    logits = torch.randn(R, V, generator=g) * 2
    seeds = torch.randint(1, 2 ** 31 - 1, (R,), generator=g,
                          dtype=torch.int64).int()
    pos = torch.randint(0, 4096, (R,), generator=g, dtype=torch.int64).int()
    st = _st(R, top_k=20, top_p=0.9)
    want, want_lp = sample(logits, st, torch.Generator().manual_seed(5),
                           row_seeds=(seeds, pos))
    drafts = torch.where(torch.arange(R) % 3 == 0, want,
                         torch.randint(-1, V, (R,), generator=g))
    got, got_lp = rejection_sample(logits, st,
                                   torch.Generator().manual_seed(9), drafts,
                                   row_seeds=(seeds, pos))
    assert torch.equal(got, want)
    assert torch.equal(got_lp, want_lp)


@pytest.mark.parametrize("draft", [2, 5, -1])
def test_rejection_sample_unseeded_rows_have_the_target_distribution(draft):
    """20,000 draws of one row (temperature 0.7, top-k 6 of 8 tokens) with
    the draft 2 (likely), 5 (masked out by top-k: always rejected) and
    none: the emitted tokens follow the processed distribution within a
    total variation of 0.02 (its expected value at this count is 0.007)."""
    from tensorrt_llm_tpu_torch.ops.sampling_ops import (mask_logits,
                                                         rejection_sample)
    n = 20_000
    logits = torch.tensor([[1.0, 0.2, 1.5, -0.3, 0.8, -2.0, 0.0, 0.4]])
    st = _st(n, top_k=6)
    tok, _ = rejection_sample(logits.expand(n, -1), st,
                              torch.Generator().manual_seed(11),
                              torch.full((n,), draft))
    want = torch.softmax(mask_logits(logits, _st(1, top_k=6)), -1)[0]
    got = torch.bincount(tok, minlength=8).float() / n
    assert got[want == 0].sum() == 0           # masked: never emitted
    tv = 0.5 * (got - want).abs().sum().item()
    assert tv < 0.02, (tv, got, want)


# ---- one fused window against JAX build_spec_window -----------------------

def _window_state(d, seed=3):
    """A state every live catch-up row of which sees a key: 3 live rows
    in slots 2, 0, 3 and a padding row; slot 1 unused."""
    rng = np.random.default_rng(seed)
    Dp = d + 1
    P = MAX_SEQ // PS
    st = dict(
        slots=np.array([2, 0, 3, -1], np.int32),
        budget=np.array([6, 2, 3 * Dp, 0], np.int32),
        max_tok=np.array([40, 9, 50, 0], np.int32),
        min_tok=np.array([0, 0, 12, 0], np.int32),
        pend_toks=rng.integers(0, 257, (S, Dp)).astype(np.int32),
        pend_n=np.array([min(2, Dp), 1, Dp, 1], np.int32),
        pos_h=np.array([Dp + 1, Dp + 3, Dp, Dp + 5], np.int32),
        pos_t=np.array([20, 33, 41, 17], np.int32),
        emitted_t=np.array([5, 7, 4, 9], np.int32),
        page_indices=np.zeros((S, P), np.int32))
    st["page_indices"][:3] = np.arange(3 * P).reshape(3, P)
    return st, rng


@pytest.mark.parametrize("d,k_lp", [(2, 0), (3, 0), (3, 5)])
def test_window_dispatch_matches_jax(models, d, k_lp):
    from tensorrt_llm_tpu.runtime import spec_window as jspec
    from tensorrt_llm_tpu_torch.llmapi.llm_args import (KvCacheConfig,
                                                        LlmArgs)
    from tensorrt_llm_tpu_torch.runtime import spec_window as tspec
    from tensorrt_llm_tpu_torch.runtime.cuda_graph import upload
    from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine
    jm, jparams, tm, tparams, _ = models
    jd, td = _drafters(models, "trained", d)
    K, Sb, Dp = 2, S, d + 1
    st, rng = _window_state(d)
    H = tm.hidden_size
    pool = (rng.standard_normal(tm.kv_pool_shape(NP, PS)) * 0.5) \
        .astype(np.float32)
    feats = rng.standard_normal((S, Dp, H)).astype(np.float32)
    P_h = MAX_SEQ // 32
    hkv = (rng.standard_normal((S * P_h, 32) + td.kv_entry_shape) * 0.5) \
        .astype(np.float32)
    stop_ids = np.full((Sb, 8), -1, np.int32)

    # JAX: the window on a stand-in engine
    jeng = SimpleNamespace(max_batch_size=S, model=jm, max_seq_len=MAX_SEQ,
                           page_size=PS, pages_per_seq=MAX_SEQ // PS,
                           num_kv_pages=NP, NSTOP=8, sd=None)
    jspec.enable_spec_device(jeng, jd, d, K)
    sd = jeng.sd
    ints = np.zeros((7, Sb), np.int32)
    ints[:4] = [st["slots"], st["budget"], st["max_tok"], st["min_tok"]]
    ints[5] = 1
    floats = np.ones((6, Sb), np.float32)
    z1 = jnp.zeros((1,), jnp.int32)
    fn = jspec.build_spec_window(jeng, K, Sb, True, False, k_lp)
    jout = fn(jparams, jnp.asarray(pool), jnp.zeros((S,), jnp.int32),
              jnp.asarray(ints), jnp.asarray(stop_ids),
              jnp.asarray(st["page_indices"]), jnp.asarray(floats), 1,
              sd.head_params, jnp.asarray(hkv), sd.embed_w, sd.lm_head_w,
              jnp.asarray(st["pend_toks"]), jnp.asarray(feats),
              jnp.asarray(st["pend_n"]), jnp.asarray(st["pos_h"]),
              jnp.asarray(st["pos_t"]), jnp.asarray(st["emitted_t"]),
              z1, jnp.zeros((1, 1), jnp.int16), jnp.zeros((1, 1), jnp.uint8),
              jnp.zeros((1,), bool), jnp.zeros((1, 1), jnp.uint8), z1)
    (jtoks, jlps, jcounts, jwin, _, jprev, _, jpt, jpf, jpn, jph, jpos,
     jemit, _, jtlv, jtli) = [np.asarray(x) for x in jout]

    # port: the same state in an engine's slot-indexed tensors
    args = LlmArgs(model="tinycode", dtype="float32", max_batch_size=S,
                   max_input_len=64, max_seq_len=MAX_SEQ,
                   kv_cache_config=KvCacheConfig(tokens_per_block=PS))
    eng = ModelEngine(tm, tparams, args, num_kv_pages=NP)
    eng.kv_pages.copy_(torch.from_numpy(pool))
    tspec.enable_spec_device(eng, td, d, K)
    t = eng.sd
    t.kv.copy_(torch.from_numpy(hkv))
    t.pend_toks[:S] = torch.from_numpy(st["pend_toks"]).long()
    t.pend_feats[:S] = torch.from_numpy(feats)
    for name in ("pend_n", "pos_h", "pos_t", "emitted_t"):
        getattr(t, name)[:S] = torch.from_numpy(st[name])
    inputs = dict(ints=ints[:4].copy(), seeds=np.zeros(Sb, np.int32),
                  stop_ids=stop_ids, page_indices=st["page_indices"])
    body = tspec.build_spec_window(eng, K, Sb, True, False, k_lp,
                                   eng.head_kv_bound(MAX_SEQ))
    out = [x.numpy() for x in body(upload(inputs, eng.device))]

    np.testing.assert_array_equal(out[0], jtoks)
    np.testing.assert_array_equal(out[2], jcounts)
    np.testing.assert_array_equal(out[3], jwin)
    np.testing.assert_allclose(out[1], jlps, atol=ATOL)
    assert jcounts.sum() > jcounts.astype(bool).sum(), \
        "no draft was accepted: the window's acceptance went untested"
    assert jcounts[:, 3].sum() == 0 and jcounts[:, :3].all(axis=1).any()
    np.testing.assert_array_equal(t.pend_toks[:S].numpy(), jpt)
    np.testing.assert_allclose(t.pend_feats[:S].numpy(), jpf, atol=1e-4,
                               rtol=1e-5)
    for name, want in (("pend_n", jpn), ("pos_h", jph), ("pos_t", jpos),
                       ("emitted_t", jemit)):
        np.testing.assert_array_equal(getattr(t, name)[:S].numpy(), want)
    np.testing.assert_array_equal(eng.prev_tokens[:S].numpy(), jprev)
    if k_lp:
        live = jtoks >= 0
        np.testing.assert_allclose(out[4][live], jtlv[live], atol=ATOL)
        np.testing.assert_array_equal(out[5][live], jtli[live])


# ---- static buffers and refusals -------------------------------------------

def _tiny_llm(**kw):
    from transformers import LlamaConfig

    from tensorrt_llm_tpu_torch import (LLM, KvCacheConfig,
                                        SpeculativeConfig)
    cfg = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=512)
    args = dict(device="cpu", dtype="float32", skip_tokenizer_init=True,
                max_batch_size=64, max_input_len=32, max_seq_len=96,
                max_num_tokens=256, decode_multi_step=6,
                speculative_config=SpeculativeConfig(mode="EAGLE3",
                                                     max_draft_len=2),
                kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                              max_tokens=8192))
    args.update(kw)
    return LLM(cfg, **args)


def test_small_spec_window_after_a_large_one_reads_no_stale_row():
    """60 rows, then 3, through one spec window key (row bucket 64, capture
    off on the CPU: the static buffer is filled and the body runs eagerly
    on it): the 3-row run gives a fresh engine's tokens, and every padding
    row of the buffer holds padding values."""
    from tensorrt_llm_tpu_torch import SamplingParams
    rng = np.random.default_rng(0)
    many = [rng.integers(1, 127, size=4).tolist() for _ in range(60)]
    few = [rng.integers(1, 127, size=5).tolist() for _ in range(3)]
    sp = SamplingParams(max_tokens=9, top_k=1, ignore_eos=True)
    llm = _tiny_llm()
    try:
        llm.generate(many, sp)
        got = [o.outputs[0].token_ids for o in llm.generate(few, sp)]
        keys = [k for k in llm.engine.graphs.steps if k[0] == "spec"]
        step = llm.engine.graphs.steps[keys[0]]
        rows = step.views["ints"].clone()
        pages = step.views["page_indices"].clone()
        stops = step.views["stop_ids"].clone()
        nonspec = llm.executor.nonspec_decode_rows
    finally:
        llm.shutdown()
    assert len(keys) == 1 and keys[0][2] == 64
    assert nonspec == 0
    live = int((rows[0] >= 0).sum())
    assert 1 <= live <= 3
    assert (rows[0, live:] == -1).all()          # no slot: inactive
    assert (rows[1:, live:] == 0).all()          # no budget, no caps
    assert (pages[live:] == 0).all()
    assert (stops[live:] == -1).all()
    fresh = _tiny_llm()
    try:
        want = [o.outputs[0].token_ids for o in fresh.generate(few, sp)]
    finally:
        fresh.shutdown()
    assert got == want


@pytest.mark.parametrize("kw,name", [
    (dict(mode="DFLASH"), "DFLASH"),
    (dict(mode="MTP"), "MTP"),
    (dict(mode="EAGLE3", eagle_tree_width=2), "eagle_tree_width"),
    (dict(mode="EAGLE3", eagle_dynamic_tree=True), "eagle_dynamic_tree"),
])
def test_refuses_what_is_not_ported_by_name(kw, name):
    """Refused by the arguments alone, and on the tiny Llama target; MTP
    only on the target (it needs an MLA target, which the arguments do
    not name)."""
    from tensorrt_llm_tpu_torch import LlmArgs, SpeculativeConfig
    if kw["mode"] != "MTP":
        with pytest.raises(NotImplementedError, match=name):
            LlmArgs(model="m", speculative_config=SpeculativeConfig(
                max_draft_len=3, **kw))
    with pytest.raises(NotImplementedError, match=name):
        _tiny_llm(speculative_config=SpeculativeConfig(max_draft_len=3,
                                                       **kw))
