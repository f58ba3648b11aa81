"""The sampling surface in the port against the JAX package on the CPU:
no-repeat-ngram, embedding bias, bad words and logits processors.

- ``ngram_ban_mask``: the port's (torch ops, an extra dropped column in
  place of ``mode="drop"``) equals the JAX one exactly on seeded
  histories, for every n in 1-8, with rows off and at the edges where the
  sampled index is below n;
- the bias add and the bad-word ban equal the JAX engine's arithmetic
  (``logits + bias``, ``where(mask, logits, finfo.min)``) exactly;
- through ``LLM.generate`` on tests/assets/tinycode-llama in float32,
  greedy tokens equal the JAX ``LLM``'s, exactly, for each option and
  the combinations the JAX package accepts, on single steps
  (``decode_multi_step=1``) and in K-step windows (8), the bias also as
  a ban by a large negative value and isolated per request on a recycled
  slot;
- logits processors on the sync scheduler: the forced token, the
  one-argument signature, a mixed batch, and sampled processor rows equal
  to the JAX package's token for token (both sample on the host with the
  same numpy routine);
- each refusal of ``submit`` with the JAX package's exception class.

Oracles: tests/test_sampling_surface.py and
tests/test_misc_features.py::test_bad_token_ids.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

CKPT = str(Path(__file__).parent / "assets" / "tinycode-llama")
PROMPTS = [list(b"def forward(self, x):\n    return "),
           list(b"for i in range(10):\n    print(i)\nfor j in range("),
           list(b"abcabcabcabcabc")]


def _kw(K, sync=False):
    return dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
                max_input_len=96, max_seq_len=160, max_num_tokens=256,
                decode_multi_step=K, disable_overlap_scheduler=sync)


@pytest.fixture(scope="module", params=[1, 8], ids=["K1", "K8"])
def llms(request):
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    K = request.param
    j = J.LLM(model=CKPT, kv_cache_config=J.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048), **_kw(K))
    t = T.LLM(CKPT, device="cpu", kv_cache_config=T.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048), **_kw(K))
    yield j, t
    j.shutdown()
    t.shutdown()


@pytest.fixture(scope="module")
def sync_llms():
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    j = J.LLM(model=CKPT, kv_cache_config=J.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048), **_kw(1, sync=True))
    t = T.LLM(CKPT, device="cpu", kv_cache_config=T.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048), **_kw(1, sync=True))
    yield j, t
    j.shutdown()
    t.shutdown()


def _sp(pkg, **kw):
    if pkg == "jax":
        from tensorrt_llm_tpu import SamplingParams
    else:
        from tensorrt_llm_tpu_torch import SamplingParams
    return SamplingParams(**kw)


def _both(pair, prompts, **kw):
    """Each package's token lists for the same prompts and params."""
    j, t = pair
    return ([o.outputs[0].token_ids for o in j.generate(prompts,
                                                         _sp("jax", **kw))],
            [o.outputs[0].token_ids for o in t.generate(prompts,
                                                        _sp("torch", **kw))])


def _no_repeat(seq, n, start):
    """No n-gram ending in the generated region repeats an earlier one."""
    for j in range(len(seq) - n + 1):
        if j + n - 1 < start:
            continue
        g = tuple(seq[j:j + n])
        for k in range(j):
            assert tuple(seq[k:k + n]) != g, (n, g, k, j)


# ---- the ops --------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_ngram_ban_mask_matches_jax(n):
    """Seeded histories over a small vocabulary (repeats are common), the
    sampled index anywhere from 0 to L, a row switched off and a row with
    n = 0: the port's mask equals the JAX one bit for bit."""
    import jax.numpy as jnp
    from tensorrt_llm_tpu.ops.sampling_ops import ngram_ban_mask as jban
    from tensorrt_llm_tpu_torch.ops.sampling_ops import ngram_ban_mask as tban
    rng = np.random.default_rng(n)
    S, L, V = 12, 40, 16
    hist = rng.integers(0, 5, size=(S, L)).astype(np.int32)
    # half the rows periodic (period 3-6), so that long grams repeat too
    for i in range(0, S, 2):
        seg = rng.integers(0, V, size=int(rng.integers(3, 7)))
        hist[i] = np.resize(seg, L)
    ns = np.full(S, n, np.int32)
    ns[1] = 0
    idx = rng.integers(0, L + 1, size=S).astype(np.int32)
    idx[2:2 + min(n, 4)] = np.arange(min(n, 4))     # sample_idx < n
    valid = np.ones(S, bool)
    valid[3] = False
    want = np.asarray(jban(jnp.asarray(hist), jnp.asarray(ns),
                           jnp.asarray(idx), jnp.asarray(valid), V))
    got = tban(torch.tensor(hist), torch.tensor(ns), torch.tensor(idx),
               torch.tensor(valid), V).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[1].any() and not got[3].any()
    assert want.any()            # the case bans something


def test_ngram_ban_mask_oracle():
    """The JAX test's hand-made case (tests/test_sampling_surface.py)."""
    from tensorrt_llm_tpu_torch.ops.sampling_ops import ngram_ban_mask
    hist = np.zeros((2, 24), np.int32)
    seq0 = [1, 2, 3, 7, 9, 5, 6, 2, 3, 7, 4, 8, 3, 7]
    seq1 = [5, 6, 2, 5, 1, 9, 5]
    hist[0, :len(seq0)] = seq0
    hist[1, :len(seq1)] = seq1
    ban = ngram_ban_mask(torch.tensor(hist), torch.tensor([3, 2]),
                         torch.tensor([len(seq0), len(seq1)]),
                         torch.tensor([True, True]), 32).numpy()
    assert set(np.where(ban[0])[0]) == {9, 4}
    assert set(np.where(ban[1])[0]) == {6, 1}


def test_bias_and_bad_words_match_the_jax_arithmetic():
    """``add_embedding_bias`` and ``ban_token_ids`` equal the JAX step's
    ``logits + bias`` and ``where(mask, logits, finfo(float32).min)``
    exactly, padding ids (-1) and out-of-vocabulary ids included."""
    import jax.numpy as jnp
    from tensorrt_llm_tpu_torch.ops.sampling_ops import (add_embedding_bias,
                                                         ban_token_ids)
    rng = np.random.default_rng(0)
    R, V = 6, 50
    logits = rng.standard_normal((R, V)).astype(np.float32) * 4
    bias = rng.standard_normal((R, V)).astype(np.float32)
    bias[2, 7] = -1e9
    bad = np.full((R, 5), -1, np.int32)
    bad[0, :3] = [1, 2, 49]
    bad[4, :2] = [0, 70]
    mask = np.ones((R, V), bool)
    for i in range(R):
        for t in bad[i]:
            if 0 <= t < V:
                mask[i, t] = False
    want = np.asarray(jnp.where(jnp.asarray(mask), jnp.asarray(logits),
                                jnp.finfo(jnp.float32).min)
                      + jnp.asarray(bias))
    got = add_embedding_bias(ban_token_ids(torch.tensor(logits),
                                           torch.tensor(bad)),
                             torch.tensor(bias)).numpy()
    np.testing.assert_array_equal(got, want)


# ---- through LLM.generate ---------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
def test_no_repeat_ngram_matches_jax(llms, n):
    j, t = _both(llms, PROMPTS, max_tokens=24, top_k=1,
                 no_repeat_ngram_size=n, ignore_eos=True)
    assert t == j
    for p, out in zip(PROMPTS, t):
        assert len(out) == 24
        _no_repeat(p + out, n, len(p))


def test_no_repeat_ngram_changes_greedy(llms):
    """The ban diverges from plain greedy once plain greedy repeats."""
    free = _both(llms, PROMPTS[2:], max_tokens=24, top_k=1,
                 ignore_eos=True)[1][0]
    banned = _both(llms, PROMPTS[2:], max_tokens=24, top_k=1,
                   no_repeat_ngram_size=2, ignore_eos=True)[1][0]
    assert banned != free
    _no_repeat(PROMPTS[2] + banned, 2, len(PROMPTS[2]))


def test_embedding_bias_matches_jax(llms):
    """A seeded dense bias on one prompt beside an unbiased one."""
    V = llms[1].model.vocab_size
    bias = np.random.default_rng(1).standard_normal(V).astype(np.float32)
    j, t = _both(llms, PROMPTS[:2], max_tokens=16, top_k=1,
                 embedding_bias=bias * 3, ignore_eos=True)
    assert t == j


def test_embedding_bias_forces_and_bans(llms):
    V = llms[1].model.vocab_size
    force = np.zeros(V, np.float32)
    force[42] = 1e9
    j, t = _both(llms, PROMPTS[:1], max_tokens=6, top_k=1,
                 embedding_bias=force, ignore_eos=True)
    assert t == j == [[42] * 6]
    free = _both(llms, PROMPTS[:1], max_tokens=12, top_k=1,
                 ignore_eos=True)[1][0]
    ban = np.zeros(V, np.float32)
    ban[free[0]] = -1e9
    j, t = _both(llms, PROMPTS[:1], max_tokens=12, top_k=1,
                 embedding_bias=ban, ignore_eos=True)
    assert t == j
    assert free[0] not in t[0]


def test_embedding_bias_per_request_isolation(llms):
    """Two concurrent requests with different biases and one without;
    then an unbiased request on the recycled slots gets no bias."""
    jl, tl = llms
    V = tl.model.vocab_size
    b1 = np.zeros(V, np.float32)
    b1[7] = 1e9
    b2 = np.zeros(V, np.float32)
    b2[9] = 1e9
    outs = {}
    for pkg, llm in (("jax", jl), ("torch", tl)):
        futs = [llm.generate_async(PROMPTS[0], _sp(
            pkg, max_tokens=5, top_k=1, embedding_bias=b, ignore_eos=True))
            for b in (b1, b2, None)]
        outs[pkg] = [f.result().outputs[0].token_ids for f in futs]
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][:2] == [[7] * 5, [9] * 5]
    after = _both(llms, PROMPTS, max_tokens=5, top_k=1, ignore_eos=True)
    plain = tl.generate(PROMPTS[0], _sp("torch", max_tokens=5, top_k=1,
                                        ignore_eos=True))
    assert after[1] == after[0]
    assert after[1][0] == outs["torch"][2] == plain.outputs[0].token_ids


def test_bad_token_ids_match_jax(llms):
    free = _both(llms, PROMPTS, max_tokens=10, top_k=1)[1]
    bad = sorted({o[0] for o in free} | {o[1] for o in free})
    j, t = _both(llms, PROMPTS, max_tokens=10, top_k=1, bad_token_ids=bad)
    assert t == j
    assert not set(bad) & {tok for o in t for tok in o}


def test_combinations_match_jax(llms):
    """No-repeat-ngram, a bias and bad words together, with sampled
    top-k 1 rows and penalties (each a graph key of its own)."""
    V = llms[1].model.vocab_size
    bias = np.random.default_rng(2).standard_normal(V).astype(np.float32)
    j, t = _both(llms, PROMPTS, max_tokens=20, top_k=1,
                 no_repeat_ngram_size=3, embedding_bias=bias,
                 bad_token_ids=[32, 101], ignore_eos=True)
    assert t == j
    j, t = _both(llms, PROMPTS, max_tokens=20, temperature=0.7, top_k=1,
                 repetition_penalty=1.3, embedding_bias=bias,
                 ignore_eos=True)
    assert t == j


def test_mixed_batch_matches_jax(llms):
    """Rows with and without each option in one batch."""
    jl, tl = llms
    V = tl.model.vocab_size
    bias = np.zeros(V, np.float32)
    bias[61] = 5.0
    opts = [dict(no_repeat_ngram_size=2), dict(embedding_bias=bias),
            dict(bad_token_ids=[115, 10]), {}]
    outs = {}
    for pkg, llm in (("jax", jl), ("torch", tl)):
        futs = [llm.generate_async(PROMPTS[i % 3], _sp(
            pkg, max_tokens=16, top_k=1, ignore_eos=True, **o))
            for i, o in enumerate(opts)]
        outs[pkg] = [f.result().outputs[0].token_ids for f in futs]
    assert outs["torch"] == outs["jax"]


# ---- logits processors (sync scheduler) -------------------------------------

def test_logits_processor_forces_token(sync_llms):
    calls = {"jax": [], "torch": []}
    outs = {}
    for pkg, llm in zip(("jax", "torch"), sync_llms):
        def proc(req_id, logits, ids, stream, client, log=calls[pkg]):
            log.append(len(ids[0]))
            logits[:] = -1e9
            logits[33] = 0.0
        outs[pkg] = llm.generate(PROMPTS[0], _sp(
            pkg, max_tokens=5, top_k=1, logits_processor=proc,
            ignore_eos=True)).outputs[0].token_ids
    assert outs["torch"] == outs["jax"] == [33] * 5
    assert calls["torch"] == calls["jax"] == [0, 1, 2, 3, 4]


def test_logits_processor_simple_signature(sync_llms):
    def proc(logits):
        out = np.full_like(logits, -1e9)
        out[55] = 0.0
        return out
    j, t = _both(sync_llms, PROMPTS[:1], max_tokens=3, top_k=1,
                 logits_processor=proc, ignore_eos=True)
    assert t == j == [[55] * 3]


def test_logits_processor_mixed_batch(sync_llms):
    """A processor row beside plain rows; the plain rows' tokens equal a
    run without the processor row."""
    def proc(req_id, logits, ids, stream, client):
        logits[:] = -1e9
        logits[21] = 0.0
    outs = {}
    for pkg, llm in zip(("jax", "torch"), sync_llms):
        futs = [llm.generate_async(PROMPTS[0], _sp(
            pkg, max_tokens=4, top_k=1, logits_processor=proc,
            ignore_eos=True))] + [
            llm.generate_async(p, _sp(pkg, max_tokens=4, top_k=1,
                                      ignore_eos=True)) for p in PROMPTS[1:]]
        outs[pkg] = [f.result().outputs[0].token_ids for f in futs]
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0] == [21] * 4
    plain = _both(sync_llms, PROMPTS[1:], max_tokens=4, top_k=1,
                  ignore_eos=True)[1]
    assert outs["torch"][1:] == plain


@pytest.mark.parametrize("seed", [3, 11])
def test_sampled_processor_rows_match_jax(sync_llms, seed):
    """A processor that keeps the logits (a bias on a few tokens) under
    temperature, top-k and top-p sampling: both packages re-sample the
    processed row on the host with the same numpy routine and seed, so
    the streams and their logprobs are equal (logprobs 1e-5: the rows'
    float32 logits differ between the packages in the last bits)."""
    def proc(logits):
        out = logits.copy()
        out[[40, 41, 42]] += 2.0
        return out
    outs = {}
    for pkg, llm in zip(("jax", "torch"), sync_llms):
        o = llm.generate(PROMPTS[1], _sp(
            pkg, max_tokens=12, temperature=0.9, top_k=20, top_p=0.9,
            seed=seed, logits_processor=proc, ignore_eos=True)).outputs[0]
        outs[pkg] = o
    assert outs["torch"].token_ids == outs["jax"].token_ids
    assert outs["torch"].cumulative_logprob == pytest.approx(
        outs["jax"].cumulative_logprob, abs=1e-5 * 12)


def test_host_sample_is_the_jax_routine():
    """``_host_sample`` equals the JAX executor's on seeded rows."""
    from tensorrt_llm_tpu.runtime.executor import _host_sample as jhs
    from tensorrt_llm_tpu_torch.runtime.executor import _host_sample as ths
    rng = np.random.default_rng(4)
    for k in range(20):
        row = rng.standard_normal(64) * 3
        kw = dict(temperature=float(rng.uniform(0.2, 1.5)),
                  top_k=int(rng.integers(0, 10)),
                  top_p=float(rng.uniform(0.3, 1.0)), seed=k + 1)
        assert ths(row, _sp("torch", **kw), k) == \
            jhs(row, _sp("jax", **kw), k)


# ---- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("case", [
    "processor_needs_sync", "ngram_too_long", "ngram_with_beam",
    "beam_needs_sync"])
def test_refusals_match_jax(llms, case):
    """``submit`` refuses what the JAX executor refuses, with its
    exception class and message."""
    kw = dict(processor_needs_sync=dict(logits_processor=lambda *a: None),
              ngram_too_long=dict(no_repeat_ngram_size=9),
              ngram_with_beam=dict(no_repeat_ngram_size=2,
                                   use_beam_search=True, best_of=2),
              beam_needs_sync=dict(use_beam_search=True, best_of=2))[case]
    errs = []
    for pkg, llm in zip(("jax", "torch"), llms):
        with pytest.raises(ValueError) as e:
            llm.generate([1, 2], _sp(pkg, max_tokens=4, **kw))
        errs.append(str(e.value))
    assert errs[1] == errs[0]


def test_ngram_with_processor_is_refused(sync_llms):
    errs = []
    for pkg, llm in zip(("jax", "torch"), sync_llms):
        with pytest.raises(ValueError) as e:
            llm.generate([1, 2], _sp(pkg, max_tokens=4,
                                     no_repeat_ngram_size=2,
                                     logits_processor=lambda x: x))
        errs.append(str(e.value))
    assert errs[1] == errs[0]


def test_guided_decoding_stays_refused(llms):
    """These LLMs have no guided backend: a guided request is refused,
    naming the knob that serves it (tests/test_torch_guided.py serves
    guided decoding)."""
    from tensorrt_llm_tpu_torch.sampling_params import GuidedDecodingParams
    with pytest.raises(ValueError, match="guided_decoding_backend"):
        llms[1].generate([1, 2], _sp("torch", max_tokens=4,
                                     guided_decoding=GuidedDecodingParams(
                                         regex="a+")))
