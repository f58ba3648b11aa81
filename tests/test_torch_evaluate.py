"""The port's ``evaluate`` package (tensorrt_llm_tpu_torch/evaluate:
accuracy_core, tasks, lm_eval_bridge) against the JAX package's on the
CPU:

- the pure functions (the statistical gate, GSM8K's number extraction,
  ROUGE-L, QA F1, the JSON-schema grader, HumanEval's truncation and its
  subprocess check) give the JAX package's results on the same inputs;
- the registry and the reference table are the JAX package's;
- each task evaluated through the port's ``LLM`` gives the JAX ``LLM``'s
  result on the same model, float32 greedy (equal scores, equal
  outputs where the task returns them): GSM8K and MMLU (through the
  port's teacher-forced scoring) on a tiny word-tokenizer model,
  LongBench on a tiny byte model, PasskeyRetrieval on the trained
  tests/assets/tinypasskey-llama (hd 48; its rows are the JAX rows, and
  it retrieves at least 80% of its keys, as the JAX test requires),
  HumanEval on the trained tests/assets/tinycode-llama;
- JsonModeEval over the port's device guided decoding: every output
  parses and conforms (the JAX test's 100% gate);
- the lm-eval bridge: ``score_continuation`` sums the prompt logprobs,
  and ``run_lm_eval`` reports the missing harness as the JAX one does.
"""
import json
from pathlib import Path

import pytest

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu.evaluate import accuracy_core as jcore
from tensorrt_llm_tpu.evaluate import tasks as jtasks
from tensorrt_llm_tpu_torch.evaluate import accuracy_core as core
from tensorrt_llm_tpu_torch.evaluate import tasks

ASSETS = Path(__file__).parent / "assets"
PASSKEY = str(ASSETS / "tinypasskey-llama")
CODE = str(ASSETS / "tinycode-llama")


class _WordTok:
    """The JAX test's whitespace tokenizer (tests/test_evaluate.py)."""
    def __init__(self):
        self.vocab = {}

    def encode(self, text, add_special_tokens=True):
        out = []
        for w in text.split():
            if w not in self.vocab:
                self.vocab[w] = 2 + (len(self.vocab) % 90)
            out.append(self.vocab[w])
        return out

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"t{i}" for i in ids)

    def convert_ids_to_tokens(self, ids):
        return [f"t{i}" for i in ids]


def _tiny_hf(vocab=96):
    import torch
    from transformers import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(0)
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=vocab, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=1024)).eval()


KW = dict(dtype="float32", max_batch_size=4, max_input_len=768,
          max_seq_len=1024, max_num_tokens=1024)


def _both(model, run, tokenizer=None, **kw):
    """run(llm) on the JAX ``LLM`` and on the port's, same model."""
    kv = dict(tokens_per_block=16, max_tokens=8192)
    j = J.LLM(model=model, tokenizer=tokenizer, enable_warmup=False,
              skip_tokenizer_init=tokenizer is None,
              kv_cache_config=J.KvCacheConfig(**kv), **{**KW, **kw})
    try:
        want = run(j)
    finally:
        j.shutdown()
    t = T.LLM(model, tokenizer=tokenizer, device="cpu",
              skip_tokenizer_init=tokenizer is None,
              kv_cache_config=T.KvCacheConfig(**kv), **{**KW, **kw})
    try:
        got = run(t)
    finally:
        t.shutdown()
    return got, want


# --------------------------------------------------------------------- #
# pure functions
# --------------------------------------------------------------------- #
def test_accuracy_core_math():
    """The port's gate is the JAX gate (test_misc_features.py's case and
    a sweep of sizes, references and sigmas)."""
    thr = core.compute_threshold(num_samples=400, reference_accuracy=74.2,
                                 sigma=40.0)
    assert 65 < thr < 74.2
    assert core.hypothesis_test_pass(73.0, 74.2, 400, 40.0)
    assert not core.hypothesis_test_pass(60.0, 74.2, 400, 40.0)
    for n, ref, sigma, hib in ((10, 50.0, 50.0, True),
                               (1319, 81.0, 39.2, True),
                               (200, 3.3, 12.0, False)):
        assert core.compute_theta(n, sigma) == jcore.compute_theta(n, sigma)
        assert core.compute_threshold(n, ref, sigma, higher_is_better=hib) \
            == jcore.compute_threshold(n, ref, sigma, higher_is_better=hib)
        for m in (ref - 20, ref - 1, ref + 1):
            assert core.hypothesis_test_pass(m, ref, n, sigma,
                                             higher_is_better=hib) == \
                jcore.hypothesis_test_pass(m, ref, n, sigma,
                                           higher_is_better=hib)
    for p in (1e-4, 0.01, 0.3, 0.5, 0.97, 0.9999):
        assert core._norm_ppf(p) == jcore._norm_ppf(p)


def test_registry_and_reference_table_are_the_jax_ones():
    assert set(tasks.TASK_REGISTRY) == set(jtasks.TASK_REGISTRY)
    assert {"gsm8k", "mmlu", "cnn_dailymail", "passkey", "humaneval",
            "json_mode_eval", "longbench"} <= set(tasks.TASK_REGISTRY)
    assert tasks.REFERENCE_ACCURACY == jtasks.REFERENCE_ACCURACY
    g = tasks.GSM8K()
    assert g.gate(73.0, 1319, "meta-llama/Llama-3.1-8B-Instruct") is True
    assert g.gate(20.0, 1319, "meta-llama/Llama-3.1-8B-Instruct") is False
    assert g.gate(50.0, 100, "nonexistent/model") is None


@pytest.mark.parametrize("text", [
    "so the answer is 42.", "1,234 apples", "#### 6", "no numbers",
    "-3.5 then 7", "x = .25"])
def test_gsm8k_extraction(text):
    assert tasks.GSM8K.extract_number(text) == \
        jtasks.GSM8K.extract_number(text)


@pytest.mark.parametrize("cand,ref", [
    ("the cat sat on the mat", "the cat sat on the mat"),
    ("completely different words here", "the cat sat"),
    ("the cat sat", "the cat sat on the mat"), ("", "x")])
def test_rouge_l(cand, ref):
    assert tasks.CnnDailymail.rouge_l_f1(cand, ref) == \
        jtasks.CnnDailymail.rouge_l_f1(cand, ref)


@pytest.mark.parametrize("pred,answers", [
    ("marina", ["marina"]), ("it was marina at dawn", ["marina"]),
    ("nothing", ["marina"]), ("", ["marina"]),
    ("the door was crimson red", ["crimson", "red door"])])
def test_qa_f1(pred, answers):
    assert tasks.LongBench.qa_f1(pred, answers) == \
        jtasks.LongBench.qa_f1(pred, answers)


def test_schema_grader_and_humaneval_helpers():
    objs = [{"name": "x", "age": 3}, {"name": "x"}, {"name": "x", "age": -1},
            {"items": ["a"], "total": 1.5}, {"items": []}, {"items": [1]},
            {"status": "ok"}, {"status": "meh"}, 3, True, None]
    for s in tasks.JsonModeEval.SCHEMAS + [
            {"anyOf": [{"type": "integer"}, {"type": "string"}]},
            {"type": "integer"}]:
        for o in objs:
            assert tasks.schema_conforms(o, s) == \
                jtasks.schema_conforms(o, s)
    c = "    return a + b\n\nprint('top level')\n"
    assert tasks.HumanEval._truncate(c) == jtasks.HumanEval._truncate(c)
    t = tasks.HumanEval()
    row = t.sample_rows()[0]
    assert t.run_one(row, "    return a + b\n")
    assert not t.run_one(row, "    return a - b\n")


def test_passkey_rows_are_the_jax_rows():
    for style in ("marker", "text"):
        kw = dict(context_len=300, depths=(0.1, 0.6), num_keys=3, seed=5,
                  style=style)
        assert tasks.PasskeyRetrieval(**kw).make_rows() == \
            jtasks.PasskeyRetrieval(**kw).make_rows()


# --------------------------------------------------------------------- #
# tasks through both LLMs
# --------------------------------------------------------------------- #
def test_gsm8k_and_mmlu_match_jax():
    def run(llm, mod):
        g = mod.GSM8K(max_tokens=8, num_shots=1).evaluate(llm)
        m = mod.MMLU().evaluate(llm)
        return g, m

    got, want = _both(_tiny_hf(), lambda llm: run(
        llm, tasks if isinstance(llm, T.LLM) else jtasks),
        tokenizer=_WordTok(), max_input_len=128, max_seq_len=256,
        max_num_tokens=256)
    assert got == want
    assert got[0]["num_samples"] == got[1]["num_samples"] == 2


def test_longbench_matches_jax():
    def run(llm):
        mod = tasks if isinstance(llm, T.LLM) else jtasks
        return mod.LongBench(context_len=256, max_tokens=8).evaluate(llm)
    got, want = _both(_tiny_hf(vocab=257), run)
    assert got == want and got["num_samples"] == 2


def test_passkey_trained_retrieval_matches_jax():
    """The JAX test_passkey_trained_retrieval_depth_sweep's settings
    (context 250, depths 0.2 / 0.5 / 0.8, two keys, marker style) on
    tinypasskey-llama (4 x 48 heads) through both ``LLM``s: the same
    outputs row by row, and the JAX test's 80% bar."""
    ctx = json.loads((Path(PASSKEY) / "meta.json").read_text()).get(
        "eval_ctx", 250)

    def run(llm):
        mod = tasks if isinstance(llm, T.LLM) else jtasks
        return mod.PasskeyRetrieval(context_len=ctx, num_keys=2,
                                    depths=(0.2, 0.5, 0.8),
                                    style="marker").evaluate(llm)
    got, want = _both(PASSKEY, run, max_batch_size=2,
                      max_input_len=ctx + 64, max_seq_len=ctx + 96,
                      max_num_tokens=ctx + 96)
    assert got["outputs"] == want["outputs"]
    assert got == want
    assert got["accuracy"] >= 80.0, got


def test_humaneval_trained_code_model_matches_jax():
    def run(llm):
        mod = tasks if isinstance(llm, T.LLM) else jtasks
        return mod.HumanEval(byte_prompts=True, max_tokens=48,
                             timeout_s=5).evaluate(llm)
    got, want = _both(CODE, run, max_batch_size=2, max_input_len=512,
                      max_seq_len=768, max_num_tokens=768)
    assert got == want and got["num_samples"] == 2


def test_json_mode_eval_guided_conformance():
    """Over the port's device guided decoding, every output parses and
    conforms to its schema (the JAX test's gate)."""
    llm = T.LLM(_tiny_hf(vocab=257), device="cpu", skip_tokenizer_init=True,
                guided_decoding_backend="dfa", guided_token_bytes="byte",
                kv_cache_config=T.KvCacheConfig(tokens_per_block=16,
                                                max_tokens=8192), **KW)
    try:
        res = tasks.JsonModeEval().evaluate(llm)
    finally:
        llm.shutdown()
    assert res["num_samples"] == 3
    assert res["json_valid_pct"] == 100.0, res
    assert res["accuracy"] == 100.0, res


def test_score_continuation_sums_prompt_logprobs():
    from tensorrt_llm_tpu_torch.evaluate.lm_eval_bridge import \
        score_continuation
    llm = T.LLM(_tiny_hf(vocab=257), device="cpu", skip_tokenizer_init=True,
                kv_cache_config=T.KvCacheConfig(tokens_per_block=16,
                                                max_tokens=4096), **KW)
    try:
        ctx, cont = [10, 20, 30], [40, 50, 60, 70]
        lp, _ = score_continuation(llm, ctx, cont)
        out = llm.generate_async(ctx + cont, T.SamplingParams(
            max_tokens=1, top_k=1, ignore_eos=True,
            prompt_logprobs=1)).result(timeout=300)
    finally:
        llm.shutdown()
    want = 0.0
    for pos in range(len(ctx), len(ctx) + len(cont)):
        d = out.prompt_logprobs[pos]
        want += d.get((ctx + cont)[pos], min(d.values()))
    assert abs(lp - want) < 1e-6 and lp < 0


def test_run_lm_eval_reports_the_missing_harness():
    from tensorrt_llm_tpu_torch.evaluate.lm_eval_bridge import run_lm_eval
    try:
        import lm_eval  # noqa: F401
        pytest.skip("lm-eval installed")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="lm-eval"):
        run_lm_eval(llm=None, tasks=["mmlu"])
