"""lm-eval-harness bridge (reference: tensorrt_llm/evaluate/lm_eval.py —
the TRTLLM lm-eval LM adapter + simple_evaluate entry).

Port of ``tensorrt_llm_tpu/evaluate/lm_eval_bridge.py`` over the port's
``LLM``: the same functions and messages; ``prompt_logprobs`` run on the
executor thread here (runtime/executor.py ``_prompt_logprobs``).

``TllmTpuLM`` adapts a :class:`~..llmapi.llm.LLM` to the lm-eval
``LM`` interface: ``loglikelihood`` scores continuations via
prompt_logprobs, ``loglikelihood_rolling`` scores whole sequences, and
``generate_until`` maps to generate with stop strings. The lm_eval
package is imported lazily — the conversion helpers below are
dependency-free so the bridge stays unit-testable in this image (which
does not ship lm-eval); against an installed harness, call
``run_lm_eval(llm, tasks=[...])``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple


def score_continuation(llm, context_ids: Sequence[int],
                       continuation_ids: Sequence[int]
                       ) -> Tuple[float, bool]:
    """(sum logprob of continuation under teacher forcing, greedy?) —
    the lm-eval ``loglikelihood`` contract."""
    from ..sampling_params import SamplingParams
    full = list(context_ids) + list(continuation_ids)
    out = llm.generate_async(full, SamplingParams(
        max_tokens=1, top_k=1, ignore_eos=True,
        prompt_logprobs=1)).result(timeout=600)
    lp_dicts = out.prompt_logprobs
    total, greedy = 0.0, True
    start = len(context_ids)
    for pos in range(start, len(full)):
        d = lp_dicts[pos]
        tok = full[pos]
        if isinstance(d, dict):
            lp = d.get(tok)
            if lp is None:           # top-1 dict lacks the actual token
                lp, greedy = min(d.values()), False
            else:
                greedy &= tok == max(d, key=d.get)
            total += float(lp)
        else:
            total += float(d)
    return total, greedy


def make_lm_class():
    """Build the lm-eval LM subclass (lazy: lm_eval must be installed)."""
    import lm_eval.api.model as lm_model

    class TllmTpuLM(lm_model.LM):
        def __init__(self, llm, tokenizer=None, batch_size: int = 16):
            super().__init__()
            self.llm = llm
            self.tokenizer = tokenizer or llm.tokenizer
            self.batch_size = batch_size

        def _encode(self, s: str) -> List[int]:
            return self.tokenizer.encode(s, add_special_tokens=False)

        def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
            out = []
            for req in requests:
                ctx, cont = req.args
                out.append(score_continuation(
                    self.llm, self._encode(ctx), self._encode(cont)))
            return out

        def loglikelihood_rolling(self, requests) -> List[float]:
            out = []
            for req in requests:
                (text,) = req.args
                ids = self._encode(text)
                lp, _ = score_continuation(self.llm, ids[:1], ids[1:])
                out.append(lp)
            return out

        def generate_until(self, requests) -> List[str]:
            from ..sampling_params import SamplingParams
            outs = []
            for req in requests:
                ctx, gen_kwargs = req.args
                until = gen_kwargs.get("until") or []
                sp = SamplingParams(
                    max_tokens=gen_kwargs.get("max_gen_toks", 256),
                    temperature=gen_kwargs.get("temperature", 0.0),
                    stop=list(until))
                r = self.llm.generate_async(ctx, sp).result(timeout=1200)
                outs.append(r.outputs[0].text or "")
            return outs

    return TllmTpuLM


def run_lm_eval(llm, tasks: List[str], tokenizer=None,
                num_fewshot: Optional[int] = None,
                limit: Optional[int] = None) -> Dict[str, Any]:
    """Run lm-eval-harness tasks against a live LLM (reference:
    lm_eval.py ``simple_evaluate`` call path)."""
    try:
        import lm_eval
    except ImportError as e:                       # pragma: no cover
        raise RuntimeError(
            "lm-eval-harness is not installed in this image; "
            "`pip install lm-eval` in a networked environment, or use "
            "the native tasks (tensorrt_llm_tpu_torch.evaluate.tasks)") from e
    lm = make_lm_class()(llm, tokenizer=tokenizer)
    return lm_eval.simple_evaluate(model=lm, tasks=tasks,
                                   num_fewshot=num_fewshot, limit=limit)
