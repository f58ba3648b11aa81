"""Task evaluators over the LLM API.

Port of ``tensorrt_llm_tpu/evaluate/tasks.py`` over the port's ``LLM``:
the same registry, reference table, sample rows, prompts, scoring and
results. MMLU scores its choices with the port's teacher-forced forward
(evaluate/perplexity.py ``score_token_logprobs``) on the caller's thread,
holding the engine's graph lock so that no CUDA graph capture on the
executor thread sees its launches; JsonModeEval decodes through the
port's guided decoding (the ``LLM`` needs a ``guided_decoding_backend``).

Role of the reference's lm-eval integration and accuracy suite
(reference: tensorrt_llm/evaluate/lm_eval.py:1, evaluate/interface.py
Evaluator, tests/integration/defs/accuracy/accuracy_core.py — tasks are
classes with an ``evaluate(llm)`` returning a score that is gated by the
hypothesis test against per-model reference values).

No dataset downloads happen here (no egress): tasks read local JSONL
files in the common public schema, so a mounted copy of the official
datasets evaluates directly. Each task also carries a tiny built-in
sample so the harness itself stays testable offline.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Sequence

from .accuracy_core import hypothesis_test_pass

TASK_REGISTRY: Dict[str, type] = {}


def register_task(name: str):
    def deco(cls):
        cls.name = name
        TASK_REGISTRY[name] = cls
        return cls
    return deco


# reference accuracy values per (task, model family) — the role of
# tests/integration/defs/accuracy/references/*.yaml
REFERENCE_ACCURACY: Dict[str, Dict[str, float]] = {
    "gsm8k": {
        "meta-llama/Llama-3.1-8B-Instruct": 74.20,
        "meta-llama/Llama-3.2-1B": 6.30,
        "Qwen/Qwen2.5-7B-Instruct": 81.00,
        "mistralai/Mixtral-8x7B-v0.1": 58.10,
    },
    "mmlu": {
        "meta-llama/Llama-3.1-8B-Instruct": 68.20,
        "meta-llama/Llama-3.2-1B": 31.10,
        "Qwen/Qwen2.5-7B-Instruct": 74.30,
        "mistralai/Mixtral-8x7B-v0.1": 70.60,
    },
    "cnn_dailymail": {
        "meta-llama/Llama-3.1-8B-Instruct": 33.90,
    },
}


class Evaluator:
    """One benchmark task (reference: evaluate/interface.py Evaluator)."""
    name = "base"

    def __init__(self, data_path: Optional[str] = None,
                 max_samples: int = 200, num_shots: int = 0,
                 max_tokens: int = 256):
        self.data_path = data_path
        self.max_samples = max_samples
        self.num_shots = num_shots
        self.max_tokens = max_tokens

    def load_rows(self) -> List[dict]:
        if self.data_path is None:
            return self.sample_rows()
        rows = []
        with open(self.data_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        return rows[:self.max_samples]

    def sample_rows(self) -> List[dict]:  # pragma: no cover - overridden
        raise NotImplementedError

    def evaluate(self, llm) -> Dict[str, Any]:
        raise NotImplementedError

    def gate(self, score: float, num_samples: int,
             model_id: Optional[str], sigma: float = 50.0
             ) -> Optional[bool]:
        ref = REFERENCE_ACCURACY.get(self.name, {}).get(model_id or "")
        if ref is None:
            return None
        return hypothesis_test_pass(score, ref, num_samples, sigma)


@register_task("gsm8k")
class GSM8K(Evaluator):
    """Exact-match on the final number, k-shot chain-of-thought prompt
    (reference task config: lm-eval gsm8k, flexible-extract filter)."""

    SHOT = ("Question: Tom has 3 apples and buys 5 more. How many apples "
            "does he have?\nAnswer: Tom starts with 3 apples and buys 5, "
            "so he has 3 + 5 = 8 apples. The answer is 8.\n\n")

    def sample_rows(self) -> List[dict]:
        return [
            {"question": "What is 2 + 3?", "answer": "#### 5"},
            {"question": "What is 10 - 4?", "answer": "#### 6"},
        ]

    @staticmethod
    def extract_number(text: str) -> Optional[str]:
        m = re.findall(r"-?[\d,]*\.?\d+", text.replace(",", ""))
        return m[-1] if m else None

    def evaluate(self, llm) -> Dict[str, Any]:
        from ..sampling_params import SamplingParams
        rows = self.load_rows()
        prefix = self.SHOT * self.num_shots
        prompts = [f"{prefix}Question: {r['question']}\nAnswer:"
                   for r in rows]
        sp = SamplingParams(max_tokens=self.max_tokens, temperature=0.0,
                            stop=["Question:"])
        outs = llm.generate(prompts, sp)
        correct = 0
        for r, o in zip(rows, outs):
            got = self.extract_number(o.outputs[0].text or "")
            gold = self.extract_number(str(r["answer"]))
            correct += int(got is not None and got == gold)
        acc = 100.0 * correct / max(len(rows), 1)
        return {"task": "gsm8k", "accuracy": round(acc, 2),
                "num_samples": len(rows)}


@register_task("mmlu")
class MMLU(Evaluator):
    """4-way multiple choice scored by continuation log-likelihood —
    more robust than generation parsing and exactly the lm-eval
    'loglikelihood' protocol (reference: lm_eval.py loglikelihood
    requests; uses teacher-forced scoring, no sampling)."""

    CHOICES = "ABCD"

    def sample_rows(self) -> List[dict]:
        return [
            {"question": "What is the capital of France?",
             "choices": ["Paris", "London", "Berlin", "Rome"],
             "answer": 0},
            {"question": "2 + 2 equals?",
             "choices": ["3", "4", "5", "6"], "answer": 1},
        ]

    def evaluate(self, llm) -> Dict[str, Any]:
        from .perplexity import score_token_logprobs
        rows = self.load_rows()
        if llm.tokenizer is None:
            raise ValueError("mmlu needs a tokenizer")
        correct = 0
        for r in rows:
            q = f"Question: {r['question']}\nAnswer:"
            scores = []
            for choice in r["choices"]:
                ids_q = llm.tokenizer.encode(q)
                ids_full = llm.tokenizer.encode(q + " " + str(choice))
                with llm.engine.graphs.lock:
                    lp = score_token_logprobs(llm.model, llm.engine.params,
                                              ids_full)
                # sum logprob over the choice continuation only
                cont = len(ids_full) - len(ids_q)
                scores.append(float(lp[-cont:].sum()))
            pred = max(range(len(scores)), key=scores.__getitem__)
            gold = r["answer"]
            if isinstance(gold, str):
                gold = self.CHOICES.index(gold.strip().upper()[0])
            correct += int(pred == gold)
        acc = 100.0 * correct / max(len(rows), 1)
        return {"task": "mmlu", "accuracy": round(acc, 2),
                "num_samples": len(rows)}


@register_task("cnn_dailymail")
class CnnDailymail(Evaluator):
    """Summarization gated on ROUGE-L F1 (reference: accuracy suite's
    cnn_dailymail rouge gates). ROUGE-L is computed in-repo via LCS —
    no rouge_score dependency."""

    def sample_rows(self) -> List[dict]:
        return [{"article": "The cat sat on the mat. It was a sunny day "
                            "in the small town.",
                 "highlights": "A cat sat on a mat on a sunny day."}]

    @staticmethod
    def rouge_l_f1(cand: str, ref: str) -> float:
        a = re.findall(r"\w+", cand.lower())
        b = re.findall(r"\w+", ref.lower())
        if not a or not b:
            return 0.0
        # O(len(a)*len(b)) LCS, two-row DP
        prev = [0] * (len(b) + 1)
        for x in a:
            cur = [0]
            for j, y in enumerate(b, 1):
                cur.append(prev[j - 1] + 1 if x == y
                           else max(prev[j], cur[-1]))
            prev = cur
        lcs = prev[-1]
        p, r = lcs / len(a), lcs / len(b)
        return 0.0 if p + r == 0 else 2 * p * r / (p + r)

    def evaluate(self, llm) -> Dict[str, Any]:
        from ..sampling_params import SamplingParams
        rows = self.load_rows()
        prompts = [f"Summarize the following article:\n"
                   f"{r['article']}\nSummary:" for r in rows]
        sp = SamplingParams(max_tokens=self.max_tokens, temperature=0.0)
        outs = llm.generate(prompts, sp)
        scores = [100.0 * self.rouge_l_f1(o.outputs[0].text or "",
                                          r["highlights"])
                  for r, o in zip(rows, outs)]
        avg = sum(scores) / max(len(scores), 1)
        return {"task": "cnn_dailymail", "rouge_l": round(avg, 2),
                "num_samples": len(rows)}


@register_task("passkey")
class PasskeyRetrieval(Evaluator):
    """Needle-in-a-haystack retrieval (reference:
    tests/integration/defs/accuracy/references/passkey_retrieval_128k.yaml
    + the passkey prompts in evaluate/lm_eval long-context suites): a
    random digit passkey is hidden at a controlled depth inside filler;
    the model must reproduce it when re-prompted. Byte-level prompts
    (token id == byte) so the task runs tokenizer-free on the committed
    tiny checkpoints; ``context_len`` and ``depths`` sweep the haystack.
    """

    def __init__(self, context_len: int = 768,
                 depths=(0.15, 0.35, 0.55, 0.75, 0.9),
                 num_keys: int = 2, seed: int = 0,
                 style: str = "text", **kw):
        super().__init__(**kw)
        self.context_len = context_len
        self.depths = tuple(depths)
        self.num_keys = num_keys
        self.seed = seed
        # "text": PASSKEY = 'x' prose needles (big models);
        # "marker": \x01 <key> \x02 needles, query = bare \x01 — the
        # tinypasskey checkpoint's trained format
        self.style = style

    FILLER_LINES = (
        b"def update(self, x):\n    return x + 1\n",
        b"for i in range(8):\n    total += vals[i]\n",
        b"if cond:\n    out = fn(a, b)\n",
        b"while ok:\n    step(world)\n",
    )

    def make_rows(self):
        import numpy as _np
        rng = _np.random.default_rng(self.seed)
        rows = []
        for depth in self.depths:
            for _ in range(self.num_keys):
                key = "".join(rng.choice(list("0123456789"), 5))
                filler = b""
                while len(filler) < self.context_len:
                    filler += self.FILLER_LINES[
                        int(rng.integers(len(self.FILLER_LINES)))]
                if self.style == "marker":
                    needle = b"\x01" + key.encode() + b"\x02"
                    tail = b"\x01"
                else:
                    needle = f"PASSKEY = '{key}'\n".encode()
                    tail = b"PASSKEY = '"
                room = self.context_len - len(needle) - len(tail)
                pos = int(room * depth)
                doc = filler[:pos] + needle + \
                    filler[pos:room] + tail
                rows.append({"prompt": list(doc), "key": key,
                             "depth": depth})
        return rows

    def evaluate(self, llm) -> Dict[str, Any]:
        from ..sampling_params import SamplingParams
        rows = self.make_rows()
        sp = SamplingParams(max_tokens=8, top_k=1, ignore_eos=True)
        futs = [llm.generate_async(r["prompt"], sp) for r in rows]
        hits, per_depth = 0, {}
        outputs = []
        for r, f in zip(rows, futs):
            out = bytes(t & 0xFF for t in
                        f.result(600).outputs[0].token_ids)
            text = out.decode(errors="replace")
            hit = r["key"] in text
            hits += hit
            per_depth.setdefault(r["depth"], []).append(hit)
            outputs.append(text)
        return {"task": "passkey", "num_samples": len(rows),
                "accuracy": 100.0 * hits / max(1, len(rows)),
                "per_depth": {d: 100.0 * sum(v) / len(v)
                              for d, v in per_depth.items()},
                "outputs": outputs}


@register_task("humaneval")
class HumanEval(Evaluator):
    """Execution-based pass@1 code completion (reference:
    evaluate/lm_eval.py humaneval task + the accuracy suite's
    references). Rows follow the official schema: ``prompt`` (function
    header + docstring), ``test`` (check() suite), ``entry_point``.
    Each completion runs in an isolated subprocess with a timeout; a
    row passes when check(entry_point) exits cleanly."""

    def __init__(self, timeout_s: float = 10.0, byte_prompts: bool = False,
                 **kw):
        kw.setdefault("max_tokens", 192)
        super().__init__(**kw)
        self.timeout_s = timeout_s
        # byte-level prompts (token id == byte) for the committed tiny
        # code checkpoint — no tokenizer needed
        self.byte_prompts = byte_prompts

    def sample_rows(self) -> List[dict]:
        return [
            {"task_id": "sample/0",
             "prompt": "def add(a, b):\n"
                       "    \"\"\"Return the sum of a and b.\"\"\"\n",
             "test": "def check(f):\n    assert f(1, 2) == 3\n"
                     "    assert f(-1, 1) == 0\n",
             "entry_point": "add"},
            {"task_id": "sample/1",
             "prompt": "def neg(x):\n"
                       "    \"\"\"Return -x.\"\"\"\n",
             "test": "def check(f):\n    assert f(3) == -3\n"
                     "    assert f(0) == 0\n",
             "entry_point": "neg"},
        ]

    @staticmethod
    def _truncate(completion: str) -> str:
        """Cut at the first top-level statement after the body (the
        standard humaneval stop heuristic)."""
        lines = []
        for ln in completion.split("\n"):
            if ln and not ln[0] in " \t)":
                break
            lines.append(ln)
        return "\n".join(lines)

    def run_one(self, row: dict, completion: str) -> bool:
        import subprocess
        import sys as _sys
        prog = (row["prompt"] + completion + "\n\n" + row["test"] +
                f"\ncheck({row['entry_point']})\n")
        try:
            r = subprocess.run([_sys.executable, "-c", prog],
                               capture_output=True,
                               timeout=self.timeout_s)
            return r.returncode == 0
        except subprocess.TimeoutExpired:
            return False

    def evaluate(self, llm) -> Dict[str, Any]:
        from ..sampling_params import SamplingParams
        rows = self.load_rows()
        sp = SamplingParams(max_tokens=self.max_tokens, top_k=1,
                            ignore_eos=True)
        if self.byte_prompts:
            futs = [llm.generate_async(list(r["prompt"].encode()), sp)
                    for r in rows]
            comps = [bytes(t & 0xFF for t in
                           f.result(600).outputs[0].token_ids)
                     .decode(errors="replace") for f in futs]
        else:
            outs = llm.generate([r["prompt"] for r in rows], sp)
            comps = [o.outputs[0].text or "" for o in outs]
        passed = 0
        for r, c in zip(rows, comps):
            passed += self.run_one(r, self._truncate(c))
        return {"task": "humaneval", "num_samples": len(rows),
                "pass@1": round(100.0 * passed / max(1, len(rows)), 2),
                "accuracy": round(100.0 * passed / max(1, len(rows)), 2)}


def schema_conforms(obj, schema: dict) -> bool:
    """Minimal JSON-Schema conformance check (type/properties/required/
    items/enum/anyOf/oneOf + numeric bounds) — the json_mode_eval
    grader (reference: evaluate/json_mode_eval; also the stress check
    for the in-repo schema->DFA compiler)."""
    if not isinstance(schema, dict):
        return True
    for alt_key in ("anyOf", "oneOf"):
        if alt_key in schema:
            return any(schema_conforms(obj, s) for s in schema[alt_key])
    t = schema.get("type")
    if t:
        types = t if isinstance(t, list) else [t]
        checks = {"object": lambda o: isinstance(o, dict),
                  "array": lambda o: isinstance(o, list),
                  "string": lambda o: isinstance(o, str),
                  "integer": lambda o: isinstance(o, int)
                  and not isinstance(o, bool),
                  "number": lambda o: isinstance(o, (int, float))
                  and not isinstance(o, bool),
                  "boolean": lambda o: isinstance(o, bool),
                  "null": lambda o: o is None}
        if not any(checks.get(tt, lambda o: True)(obj) for tt in types):
            return False
    if "enum" in schema and obj not in schema["enum"]:
        return False
    if isinstance(obj, dict):
        for k in schema.get("required", []):
            if k not in obj:
                return False
        for k, sub in (schema.get("properties") or {}).items():
            if k in obj and not schema_conforms(obj[k], sub):
                return False
        if schema.get("additionalProperties") is False:
            if set(obj) - set(schema.get("properties") or {}):
                return False
    if isinstance(obj, list):
        items = schema.get("items")
        if isinstance(items, dict):
            if not all(schema_conforms(v, items) for v in obj):
                return False
        if "minItems" in schema and len(obj) < schema["minItems"]:
            return False
        if "maxItems" in schema and len(obj) > schema["maxItems"]:
            return False
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        if "minimum" in schema and obj < schema["minimum"]:
            return False
        if "maximum" in schema and obj > schema["maximum"]:
            return False
    return True


@register_task("json_mode_eval")
class JsonModeEval(Evaluator):
    """Schema-constrained generation (reference: the json_mode_eval
    dataset in evaluate/; rows carry a prompt + a JSON schema). Runs
    guided decoding end-to-end: generation uses
    GuidedDecodingParams(json=schema); graded on (a) output parses as
    JSON and (b) conforms to the schema — which stresses the in-repo
    schema->DFA compiler on real nested/typed schemas."""

    SCHEMAS = [
        {"type": "object",
         "properties": {"name": {"type": "string"},
                        "age": {"type": "integer", "minimum": 0}},
         "required": ["name", "age"], "additionalProperties": False},
        {"type": "object",
         "properties": {"items": {"type": "array",
                                  "items": {"type": "string"},
                                  "minItems": 1, "maxItems": 3},
                        "total": {"type": "number"}},
         "required": ["items"]},
        {"type": "object",
         "properties": {"status": {"enum": ["ok", "error"]},
                        "code": {"type": "integer"}},
         "required": ["status"]},
    ]

    def sample_rows(self) -> List[dict]:
        return [{"prompt": f"Emit a JSON object #{i}: ",
                 "schema": s} for i, s in enumerate(self.SCHEMAS)]

    def __init__(self, **kw):
        # worst-case canonical output under the bounded grammar: 3
        # 64-char strings + keys + ws ≈ 280 bytes
        kw.setdefault("max_tokens", 384)
        super().__init__(**kw)

    def evaluate(self, llm) -> Dict[str, Any]:
        from ..sampling_params import GuidedDecodingParams, SamplingParams
        rows = self.load_rows()
        futs = []
        for r in rows:
            schema = r["schema"]
            if isinstance(schema, str):
                schema = json.loads(schema)
            # no ignore_eos: once the grammar accepts, only EOS stays
            # unmasked, so generation ends exactly at the JSON's end
            sp = SamplingParams(
                max_tokens=self.max_tokens, top_k=1,
                guided_decoding=GuidedDecodingParams(json=schema))
            prompt = r["prompt"]
            if isinstance(prompt, str):
                prompt = list(prompt.encode())
            futs.append((schema, llm.generate_async(prompt, sp)))
        parsed = conform = 0
        for schema, f in futs:
            out = f.result(600).outputs[0]
            text = out.text or bytes(
                t & 0xFF for t in out.token_ids).decode(errors="replace")
            # tokenizer-free byte models pad past grammar-accept with
            # EOS (id 0) bytes; cut at the first NUL
            text = text.split("\x00")[0]
            try:
                obj = json.loads(text)
                parsed += 1
            except Exception:
                continue
            conform += schema_conforms(obj, schema)
        n = max(1, len(rows))
        return {"task": "json_mode_eval", "num_samples": len(rows),
                "json_valid_pct": round(100.0 * parsed / n, 2),
                "accuracy": round(100.0 * conform / n, 2)}


@register_task("longbench")
class LongBench(Evaluator):
    """LongBench-style long-context QA graded by token-level F1
    (reference: evaluate/ longbench task; qa_f1_score metric). Rows:
    ``context``, ``question``, ``answers`` (list). Offline sample rows
    hide facts in filler at depth, byte-level prompts."""

    def __init__(self, context_len: int = 512, **kw):
        kw.setdefault("max_tokens", 24)
        super().__init__(**kw)
        self.context_len = context_len

    @staticmethod
    def qa_f1(pred: str, answers: Sequence[str]) -> float:
        def toks(s):
            return re.findall(r"[a-z0-9]+", s.lower())
        p = toks(pred)
        best = 0.0
        for a in answers:
            g = toks(a)
            if not p or not g:
                continue
            common = {}
            for t in p:
                common[t] = min(p.count(t), g.count(t))
            overlap = sum(common.values())
            if overlap == 0:
                continue
            prec, rec = overlap / len(p), overlap / len(g)
            best = max(best, 2 * prec * rec / (prec + rec))
        return best

    def sample_rows(self) -> List[dict]:
        filler = ("The library catalogue lists many entries. " * 40)
        rows = []
        facts = [("Who fixed the beacon?", "marina", 0.2),
                 ("What color was the door?", "crimson", 0.7)]
        for q, a, depth in facts:
            fact = {"marina": "Marina fixed the beacon at dawn. ",
                    "crimson": "The door was painted crimson. "}[a]
            pos = int(len(filler) * depth)
            ctx = filler[:pos] + fact + filler[pos:self.context_len]
            rows.append({"context": ctx[:self.context_len],
                         "question": q, "answers": [a]})
        return rows

    def evaluate(self, llm) -> Dict[str, Any]:
        from ..sampling_params import SamplingParams
        rows = self.load_rows()
        sp = SamplingParams(max_tokens=self.max_tokens, top_k=1,
                            ignore_eos=True)
        futs = []
        for r in rows:
            prompt = (f"{r['context']}\n\nQuestion: {r['question']}\n"
                      f"Answer:")
            futs.append(llm.generate_async(list(prompt.encode()), sp))
        scores = []
        for r, f in zip(rows, futs):
            out = f.result(600).outputs[0]
            text = out.text or bytes(
                t & 0xFF for t in out.token_ids).decode(errors="replace")
            scores.append(self.qa_f1(text, r["answers"]))
        return {"task": "longbench", "num_samples": len(rows),
                "f1": round(100.0 * sum(scores) / max(1, len(scores)), 2),
                "accuracy": round(
                    100.0 * sum(scores) / max(1, len(scores)), 2)}
