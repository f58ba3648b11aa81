"""Beam search in the port (runtime/beam_search.py) on the CPU, with
tests/assets/tinycode-llama in float32:

- the JAX package's three cases (tests/test_beam_search.py): width 2
  with n = 1 scores no worse than greedy, n distinct hypotheses sorted by
  score, the same hypotheses twice;
- hypotheses and cumulative logprobs equal to plain beam search on the
  ``transformers`` model of the same checkpoint (tokens exactly, scores
  within 1e-4), and every hypothesis's score equal to the teacher-forced
  log-probability of its tokens (``score_token_logprobs``, 1e-4): a
  beam's KV is its own tokens' after every fork;
- three reference faults, each against the port: the JAX group's
  returned scores leave out the last token's log-probability, its
  page-by-page fork copy loses a page when two beams swap, and a
  finished group ends another group's rows;
- a beam fork copies pages on the device (``pages_copied`` > 0).
"""
from pathlib import Path

import numpy as np
import pytest

CKPT = str(Path(__file__).parent / "assets" / "tinycode-llama")
PROMPTS = [list(b"def forward(self, x):\n    return "),
           list(b"import numpy as np\nimport "),
           list(b"for i in range(10):\n    print(")]
TOL = 1e-4


def _kw():
    return dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=8,
                max_input_len=96, max_seq_len=160, max_num_tokens=256,
                max_beam_width=4)


@pytest.fixture(scope="module")
def llms():
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    j = J.LLM(model=CKPT, kv_cache_config=J.KvCacheConfig(
        tokens_per_block=16, max_tokens=4096), **_kw())
    t = T.LLM(CKPT, device="cpu", kv_cache_config=T.KvCacheConfig(
        tokens_per_block=16, max_tokens=4096), **_kw())
    yield j, t
    j.shutdown()
    t.shutdown()


def _sp(pkg, **kw):
    if pkg == "jax":
        from tensorrt_llm_tpu import SamplingParams
    else:
        from tensorrt_llm_tpu_torch import SamplingParams
    return SamplingParams(**kw)


def _beam(llm, pkg, prompt, **kw):
    out = llm.generate(prompt, _sp(pkg, use_beam_search=True,
                                   length_penalty=0.0, **kw))
    return [(o.token_ids, o.cumulative_logprob) for o in out.outputs]


def test_beam_width1_equals_greedy(llms):
    t = llms[1]
    greedy = t.generate(PROMPTS[0], _sp("torch", max_tokens=6, top_k=1))
    beam = t.generate(PROMPTS[0], _sp("torch", max_tokens=6,
                                      use_beam_search=True, best_of=2, n=1,
                                      length_penalty=0.0))
    assert beam.outputs[0].cumulative_logprob >= \
        greedy.outputs[0].cumulative_logprob - TOL
    assert len(beam.outputs[0].token_ids) == 6


def test_beam_returns_n_distinct(llms):
    out = _beam(llms[1], "torch", PROMPTS[1], max_tokens=5, best_of=4, n=3)
    assert len(out) == 3
    assert len({tuple(t) for t, _ in out}) == 3
    scores = [s for _, s in out]
    assert scores == sorted(scores, reverse=True)


def test_beam_deterministic(llms):
    a = _beam(llms[1], "torch", PROMPTS[2], max_tokens=5, best_of=3, n=2)
    b = _beam(llms[1], "torch", PROMPTS[2], max_tokens=5, best_of=3, n=2)
    # the second run reuses the first's prompt blocks, whose prefill ran
    # in other shapes: scores may differ in the last float32 bits
    assert [t for t, _ in a] == [t for t, _ in b]
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b],
                               rtol=0, atol=1e-5)


def _teacher_forced(llm, prompt, tokens):
    from tensorrt_llm_tpu_torch.evaluate.perplexity import \
        score_token_logprobs
    lp = score_token_logprobs(llm.model, llm.engine.params, prompt + tokens)
    return float(lp[len(prompt) - 1:].astype(np.float64).sum())


@pytest.fixture(scope="module")
def hf():
    import torch
    from transformers import LlamaForCausalLM
    return LlamaForCausalLM.from_pretrained(CKPT,
                                            torch_dtype=torch.float32).eval()


def _reference_beam(hf, prompt, width, n, steps):
    """Plain beam search on the ``transformers`` model (no EOS, length
    penalty 0): each beam's top-``width`` next tokens, the best
    ``width`` continuations kept, the best ``n`` returned."""
    import torch
    beams = [([], 0.0)]
    for _ in range(steps):
        cands = []
        for toks, score in beams:
            with torch.no_grad():
                logits = hf(torch.tensor([prompt + toks])).logits[0, -1]
            lp = torch.log_softmax(logits.float(), -1)
            vals, ids = torch.topk(lp, width)
            cands += [(score + float(v), toks + [int(i)])
                      for v, i in zip(vals, ids)]
        cands.sort(key=lambda c: -c[0])
        beams = [(t, s) for s, t in cands[:width]]
    return beams[:n]


@pytest.mark.parametrize("width,n", [(2, 2), (3, 2), (4, 3)])
def test_beam_matches_reference(llms, hf, width, n):
    """The port's hypotheses are plain beam search's on the
    ``transformers`` model: tokens exactly, scores within 1e-4; and every
    score is its tokens' teacher-forced log-probability."""
    t = llms[1]
    for p in PROMPTS:
        want = _reference_beam(hf, p, width, n, 8)
        got = _beam(t, "torch", p, max_tokens=8, best_of=width, n=n)
        assert [g[0] for g in got] == [w[0] for w in want]
        np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                                   rtol=0, atol=TOL)
        for toks, score in got:
            assert score == pytest.approx(_teacher_forced(t, p, toks),
                                          abs=TOL)


def test_jax_beam_scores_omit_the_last_token(llms):
    """Reference fault: at ``max_tokens`` the JAX group also returns each
    live row's tokens, the token its last step sampled included, with the
    score of the tokens before it. Its best hypothesis's score is then
    not its tokens' log-probability (here off by more than 1e-3), where
    the port's is (1e-4)."""
    j, t = llms
    p = PROMPTS[0]
    jax_best = _beam(j, "jax", p, max_tokens=8, best_of=3, n=2)[0]
    port_best = _beam(t, "torch", p, max_tokens=8, best_of=3, n=2)[0]
    assert abs(jax_best[1] - _teacher_forced(t, p, jax_best[0])) > 1e-3
    assert port_best[1] == pytest.approx(
        _teacher_forced(t, p, port_best[0]), abs=TOL)


class _Pages:
    """A stand-in engine whose KV pool is a dict page -> content."""

    def __init__(self, rows):
        self.pool = {}
        for r in rows:
            for b in r.kv_block_ids:
                self.pool[b] = ("row", r.request_id, b)

    def copy_page(self, src, dst):            # the JAX engine's copy
        self.pool[dst] = self.pool[src]

    def copy_pages(self, src, dst, pool=0):    # the port's
        vals = [self.pool[s] for s in src]
        for d, v in zip(dst, vals):
            self.pool[d] = v


class _Kv:
    tokens_per_block = 4

    def pool_block_ids(self, r):
        return [list(r.kv_block_ids)]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_beam_fork_swap(pkg):
    """Two beams trade places in one step: row 0 continues row 1's beam
    and row 1 row 0's. Each must then hold the other's generated page as
    it was. The port's fork reads every source page before it writes one;
    the JAX group copies page by page (a reference fault): row 1 gets back
    its own page, which row 0's copy had just overwritten."""
    if pkg == "jax":
        from tensorrt_llm_tpu.runtime import beam_search as bs
        from tensorrt_llm_tpu.runtime.request import LlmRequest
    else:
        from tensorrt_llm_tpu_torch.runtime import beam_search as bs
        from tensorrt_llm_tpu_torch.runtime.request import LlmRequest
    parent = LlmRequest([1, 2, 3, 4, 5, 6], _sp(pkg, max_tokens=8,
                                                use_beam_search=True,
                                                best_of=2, n=2))
    rows = bs.make_beam_rows(parent)
    group = bs.BeamGroup(parent, rows)
    group.first_step = False
    group.scores = [-1.0, -1.5]
    for i, r in enumerate(rows):
        r.kv_block_ids = [0, 10 + i]         # prompt page, generated page
        r.output_token_ids = [20 + i, 30 + i]
    # row 1's continuation is best, row 0's second: the plan swaps them
    rows[0].logprobs = [{40: -2.0}]
    rows[1].logprobs = [{41: -0.1}]
    eng = _Pages(rows)
    before = dict(eng.pool)
    group.update(eng, _Kv())
    assert [r.output_token_ids for r in rows] == [[21, 41], [20, 40]]
    got = (eng.pool[10], eng.pool[11])
    want = (before[11], before[10])
    if pkg == "torch":
        assert got == want
    else:
        assert got[0] == want[0] and got[1] != want[1]


def test_concurrent_beam_groups(llms):
    """Three groups of width 4 in one call, 12 rows for 8 slots: each
    group returns what it returns alone. The port starts a group only
    when its rows fit, and ends a finished group's own rows. The JAX
    executor ends the rows of the group its re-ranking loop visited last
    (a reference fault): the third group's rows are cancelled when the
    first group finishes, and its result never comes (here: not within
    20 s, where a group takes well under a second)."""
    j, t = llms
    sp = dict(max_tokens=10, best_of=4, n=2)
    alone = [_beam(t, "torch", p, **sp) for p in PROMPTS]
    outs = t.generate(PROMPTS, _sp("torch", use_beam_search=True,
                                   length_penalty=0.0, **sp))
    together = [[(o.token_ids, o.cumulative_logprob) for o in r.outputs]
                for r in outs]
    assert [[h[0] for h in g] for g in together] == \
        [[h[0] for h in g] for g in alone]
    assert not t.executor._beam_groups
    futs = [j.generate_async(p, _sp("jax", use_beam_search=True,
                                    length_penalty=0.0, **sp))
            for p in PROMPTS]
    futs[0].result(timeout=120)
    with pytest.raises(TimeoutError):
        futs[2].result(timeout=20)


def test_beam_forks_copy_pages(llms):
    t = llms[1]
    e = t.engine
    forks, pages = t.executor.beam_forks, e.pages_copied
    _beam(t, "torch", PROMPTS[0], max_tokens=20, best_of=4, n=4)
    assert t.executor.beam_forks > forks
    assert e.pages_copied > pages
    assert not t.executor._beam_groups
