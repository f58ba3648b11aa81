"""EAGLE3 speculative decoding end to end through the port's ``LLM`` on
the CPU (the plain versions of the attention kernels), float32.

- The in-repo pair (target tests/assets/tinycode-llama, trained head
  tests/assets/tinycode-eagle), d = 2 and 3: the port's greedy spec
  tokens equal the JAX package's non-spec tokens and the port's own; the
  mean drafts accepted per iteration is >= 0.5, and within a stated bound
  of the JAX package's (the catch-up fault of runtime/spec_window.py: a
  request's first iterations, while the head's verified history is
  shorter than d+1, propose draft 0 from a row that sees no key, where
  the JAX reference attends to the mean of V; each such iteration can
  change its count by at most d, and there are at most d+1 of them per
  request). A random head accepts close to nothing by contrast.
- Counterparts of tests/test_spec_window.py on its tiny model (saved HF
  weights): riding the overlap scheduler, stop ids and the max_tokens
  budget inside windows, streaming, seeded sampled rows (bit-identical to
  non-speculative seeded sampling), a greedy row beside an unseeded
  sampled row, logprobs rows, a penalty row split off to single steps.
- A weight-only quantized target (W4A16, per channel) with the trained
  head: greedy tokens equal the JAX package's.
"""
import time
from pathlib import Path

import numpy as np
import pytest

CKPT = Path(__file__).parent / "assets" / "tinycode-llama"
HEAD = Path(__file__).parent / "assets" / "tinycode-eagle"
PROMPTS = [
    "def forward(self, params, token_ids, kv_pages, metadata):\n"
    "    logits, kv_pages = self.model.forward(params, token_ids,\n",
    "import numpy as np\n\n\ndef softmax(x):\n    ",
    "class Cache:\n    def __init__(self, size):\n        self.size = ",
]
N_OUT = 48


def _pkg(name):
    if name == "jax":
        import tensorrt_llm_tpu as pkg
        from tensorrt_llm_tpu.llmapi.llm_args import SpeculativeConfig
    else:
        import tensorrt_llm_tpu_torch as pkg
        from tensorrt_llm_tpu_torch import SpeculativeConfig
    return pkg, SpeculativeConfig


def _tinycode(name, d=None, head=str(HEAD), **kw):
    pkg, SC = _pkg(name)
    args = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
                max_input_len=256, max_seq_len=512, max_num_tokens=512,
                kv_cache_config=pkg.KvCacheConfig(tokens_per_block=16,
                                                  max_tokens=4096))
    if name == "jax":
        args.update(model=str(CKPT), enable_warmup=False)
    else:
        args.update(model=str(CKPT), device="cpu")
    if d is not None:
        args["speculative_config"] = SC(mode="EAGLE3", max_draft_len=d,
                                        draft_model=head)
    args.update(kw)
    return pkg, pkg.LLM(**args)


def _run(name, d=None, **kw):
    """Greedy tokens of PROMPTS, and the mean drafts accepted per
    iteration (None without speculation)."""
    pkg, llm = _tinycode(name, d, **kw)
    try:
        outs = llm.generate([list(p.encode()) for p in PROMPTS],
                            pkg.SamplingParams(max_tokens=N_OUT, top_k=1,
                                               ignore_eos=True))
        acc = None
        if d is not None:
            dr = llm.executor.drafter
            acc = (float(np.sum(dr.acceptance_window)),
                   len(dr.acceptance_window))
    finally:
        llm.shutdown()
    return [o.outputs[0].token_ids for o in outs], acc


@pytest.fixture(scope="module")
def baseline():
    return {"jax": _run("jax")[0], "torch": _run("torch")[0]}


@pytest.mark.parametrize("d", [2, 3])
def test_tinycode_spec_equals_jax_and_accepts(baseline, d):
    got, (acc_sum, iters) = _run("torch", d)
    jax_got, (jax_sum, jax_iters) = _run("jax", d)
    assert baseline["torch"] == baseline["jax"]
    assert got == baseline["jax"]
    assert jax_got == baseline["jax"]
    assert [len(t) for t in got] == [N_OUT] * len(PROMPTS)
    assert acc_sum / iters >= 0.5, (acc_sum, iters)
    # the catch-up fault: at most d+1 iterations per request, each off by
    # at most d drafts (module docstring)
    bound = len(PROMPTS) * (d + 1) * d
    assert abs(acc_sum - jax_sum) <= bound, (acc_sum, jax_sum, bound)
    assert abs(iters - jax_iters) <= bound, (iters, jax_iters, bound)


def test_untrained_head_accepts_nothing_by_contrast():
    """A random head on the same target accepts close to nothing: the
    acceptance above is the training, not the machinery."""
    _, (acc_sum, iters) = _run("torch", 2, head=None)
    assert iters and acc_sum / iters <= 0.2, (acc_sum, iters)


def test_w4a16_target_with_trained_head_matches_jax():
    """A weight-only quantized target (int4 per channel, lm_head
    excluded, as by default): greedy spec tokens equal the JAX package's
    spec and non-spec tokens (both dequantize in float32)."""
    out = {}
    for name in ("jax", "torch"):
        pkg, _ = _pkg(name)
        qc = pkg.QuantConfig(quant_algo=pkg.QuantAlgo.W4A16)
        out[name] = _run(name, 2, quant_config=qc)[0]
        if name == "jax":
            out["jax_base"] = _run(name, quant_config=qc)[0]
    assert out["torch"] == out["jax"] == out["jax_base"]


# ---- counterparts of tests/test_spec_window.py ---------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    import torch
    from transformers import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(3)
    cfg = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=512)
    path = tmp_path_factory.mktemp("tiny_spec")
    LlamaForCausalLM(cfg).eval().save_pretrained(path,
                                                 safe_serialization=True)
    return str(path)


def make_llm(path, d=None, **kw):
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig, SpeculativeConfig
    args = dict(device="cpu", skip_tokenizer_init=True, dtype="float32",
                max_batch_size=8, max_input_len=64, max_seq_len=128,
                max_num_tokens=256,
                kv_cache_config=KvCacheConfig(tokens_per_block=16,
                                              max_tokens=2048))
    if d is not None:
        args["speculative_config"] = SpeculativeConfig(
            mode="EAGLE3", max_draft_len=d,
            device_window_iters=kw.pop("iters", 0))
    args.update(kw)
    return LLM(path, **args)


def _sp(**kw):
    from tensorrt_llm_tpu_torch import SamplingParams
    return SamplingParams(**kw)


def _toks(llm, prompts, sp):
    return [o.outputs[0].token_ids for o in llm.generate(prompts, sp)]


def _keys(llm):
    return [k for k in llm.engine.graphs.steps if k[0] == "spec"]


def test_eagle3_rides_overlap(tiny):
    prompts = [[5, 9, 23, 44, 17], [3, 3, 7, 3, 3, 7, 3, 3]]
    sp = _sp(max_tokens=12, top_k=1)
    base = make_llm(tiny)
    ref = _toks(base, prompts, sp)
    base.shutdown()
    spec = make_llm(tiny, 3)
    try:
        assert spec.executor.enable_overlap      # not forced to sync
        assert spec.engine.sd is not None        # device windows armed
        got = _toks(spec, prompts, sp)
        assert _keys(spec) and spec.engine.sd.windows > 0
        assert spec.executor.nonspec_decode_rows == 0
    finally:
        spec.shutdown()
    assert got == ref


def test_spec_window_stop_ids_and_budget(tiny):
    """Stop tokens inside a window truncate on the device; max_tokens is
    an absolute gate on the device-resident emitted count."""
    prompt = [5, 9, 23, 44, 17]
    base = make_llm(tiny)
    ref = _toks(base, [prompt], _sp(max_tokens=20, top_k=1))[0]
    base.shutdown()
    spec = make_llm(tiny, 3, iters=4)
    try:
        assert spec.engine.sd.K == 4
        got = _toks(spec, [prompt], _sp(max_tokens=20, top_k=1,
                                        stop_token_ids=[ref[3]]))[0]
        assert got == ref[:ref.index(ref[3]) + 1]
        got2 = _toks(spec, [prompt], _sp(max_tokens=5, top_k=1))[0]
        assert got2 == ref[:5]
        got3 = _toks(spec, [prompt], _sp(max_tokens=20, top_k=1,
                                         stop_token_ids=[ref[0]],
                                         min_tokens=6))[0]
    finally:
        spec.shutdown()
    after = [i for i in range(6, 20) if ref[i - 1] == ref[0]]
    assert got3 == (ref[:after[0]] if after else ref)


def test_spec_window_streams(tiny):
    """Windows under continuous batching: concurrent requests of different
    lengths, one of them streaming its tokens as windows complete."""
    spec = make_llm(tiny, 2)
    try:
        futs = [spec.generate_async([i + 1, i + 2, i + 3],
                                    _sp(max_tokens=6 + i, top_k=1),
                                    streaming=i == 0)
                for i in range(4)]
        streamed = [t for o in futs[0] for t in o.token_ids]
        outs = [f.result(timeout=300).outputs[0].token_ids for f in futs]
    finally:
        spec.shutdown()
    assert streamed == outs[0]
    base = make_llm(tiny)
    try:
        for i, o in enumerate(outs):
            assert len(o) == 6 + i
            assert o == _toks(base, [[i + 1, i + 2, i + 3]],
                              _sp(max_tokens=6 + i, top_k=1))[0]
    finally:
        base.shutdown()


def test_seeded_sampled_window_lossless(tiny):
    """Seeded sampled rows ride the window by position-keyed
    sample-and-match: the stream is bit-identical to non-speculative
    seeded sampling."""
    prompts = [[5, 9, 23], [7, 8, 9, 10]]
    sp = _sp(max_tokens=10, temperature=0.8, top_k=0, top_p=0.95,
             seed=1234)
    base = make_llm(tiny)
    ref = _toks(base, prompts, sp)
    base.shutdown()
    spec = make_llm(tiny, 3)
    try:
        got = _toks(spec, prompts, sp)
        assert any(k[3] is False and k[4] is True for k in _keys(spec))
    finally:
        spec.shutdown()
    assert got == ref


def test_greedy_row_beside_unseeded_sampled_row(tiny):
    """A greedy row and an unseeded sampled row (rejection sampling) share
    windows: the greedy row still equals non-speculative decoding."""
    spec = make_llm(tiny, 2)
    try:
        f1 = spec.generate_async([5, 9, 23], _sp(max_tokens=8, top_k=1))
        f2 = spec.generate_async([7, 8, 9], _sp(max_tokens=8,
                                                temperature=0.9, top_k=0))
        g1 = f1.result(timeout=300).outputs[0].token_ids
        g2 = f2.result(timeout=300).outputs[0].token_ids
        assert any(k[3] is False and k[4] is False for k in _keys(spec))
    finally:
        spec.shutdown()
    base = make_llm(tiny)
    ref = _toks(base, [[5, 9, 23]], _sp(max_tokens=8, top_k=1))[0]
    base.shutdown()
    assert g1 == ref
    assert len(g2) == 8 and all(0 <= t < 64 for t in g2)


def test_mixed_batch_splits_spec_from_logprobs_rows(tiny):
    """A logprobs row beside a plain row: both ride spec windows (top-k
    logprobs are computed inside the window) and both are lossless."""
    sp_fast = _sp(max_tokens=12, top_k=1)
    sp_lp = _sp(max_tokens=12, top_k=1, logprobs=1)
    spec = make_llm(tiny, 2)
    try:
        f1 = spec.generate_async([5, 9, 23], sp_fast)
        f2 = spec.generate_async([7, 8, 9], sp_lp)
        g1 = f1.result(timeout=300).outputs[0].token_ids
        o2 = f2.result(timeout=300).outputs[0]
        assert _keys(spec)
    finally:
        spec.shutdown()
    base = make_llm(tiny)
    r1 = _toks(base, [[5, 9, 23]], sp_fast)[0]
    r2 = base.generate([[7, 8, 9]], sp_lp)[0].outputs[0]
    base.shutdown()
    assert g1 == r1
    assert o2.token_ids == r2.token_ids
    assert o2.logprobs is not None


def test_penalty_row_splits_off_to_single_steps(tiny):
    """A row with a repetition penalty does not qualify for the window
    (``_spec_row_ok``): it decodes in single steps beside the spec rows,
    which keep their windows; everyone equals non-speculative decoding."""
    prompts = [[5, 9, 23], [7, 8, 9], [3, 3, 7]]
    sps = [_sp(max_tokens=10, top_k=1),
           _sp(max_tokens=10, top_k=1, repetition_penalty=1.3),
           _sp(max_tokens=10, top_k=1)]
    spec = make_llm(tiny, 2)
    try:
        got = [o.outputs[0].token_ids for o in spec.generate(prompts, sps)]
        windows = spec.engine.sd.windows
        nonspec = spec.executor.nonspec_decode_rows
    finally:
        spec.shutdown()
    base = make_llm(tiny)
    ref = [o.outputs[0].token_ids for o in base.generate(prompts, sps)]
    base.shutdown()
    assert got == ref
    assert windows > 0 and nonspec >= 9


def test_logprobs_inside_spec_window(tiny):
    """Top-k logprobs ride the fused window: values match the
    non-speculative logprobs path."""
    prompts = [[5, 9, 23, 44, 17]]
    sp = _sp(max_tokens=8, top_k=1, logprobs=3, ignore_eos=True)
    base = make_llm(tiny)
    r0 = base.generate(prompts, sp)[0].outputs[0]
    base.shutdown()
    spec = make_llm(tiny, 3)
    try:
        r1 = spec.generate(prompts, sp)[0].outputs[0]
        assert any(k[5] > 0 for k in _keys(spec))
    finally:
        spec.shutdown()
    assert r1.token_ids == r0.token_ids
    assert len(r0.logprobs) == len(r1.logprobs) == 8
    for d0, d1 in zip(r0.logprobs, r1.logprobs):
        assert set(d0) == set(d1)
        for t in d0:
            assert abs(d0[t] - d1[t]) < 1e-3, (d0, d1)


def test_spec_window_dispatch_is_counted(tiny):
    """The engine's counters: windows, their iterations and the iterations
    the host knew to be dead; acceptance totals on the drafter."""
    spec = make_llm(tiny, 2, iters=3)
    try:
        t0 = time.monotonic()
        _toks(spec, [[5, 9, 23]], _sp(max_tokens=7, top_k=1))
        assert time.monotonic() - t0 < 120
        sd, dr = spec.engine.sd, spec.executor.drafter
        assert sd.iters == 3 * sd.windows and sd.windows >= 1
        assert 0 <= sd.dead_iters < sd.iters
        assert dr.steps_total >= sd.windows
        assert dr.accepted_total == sum(dr.acceptance_window)
    finally:
        spec.shutdown()
