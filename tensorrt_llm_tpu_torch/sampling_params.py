"""User-facing sampling parameters.

Port of ``tensorrt_llm_tpu/sampling_params.py``, unchanged. Values are
validated eagerly; the engine packs them into batched device tensors
(ops/sampling_ops.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, List, Optional, Sequence, Union


class LogprobsMode(str, Enum):
    """Reference: sampling_params.py:77 — logprobs before/after processing."""
    RAW = "raw"
    PROCESSED = "processed"


@dataclass(slots=True)
class GuidedDecodingParams:
    """Grammar-constrained generation spec (reference: sampling_params.py:43-58)."""
    json: Optional[Union[str, dict]] = None
    regex: Optional[str] = None
    grammar: Optional[str] = None
    json_object: bool = False
    structural_tag: Optional[str] = None

    def __post_init__(self):
        n = sum(x is not None for x in (self.json, self.regex, self.grammar,
                                        self.structural_tag)) + int(self.json_object)
        if n > 1:
            raise ValueError("only one guided decoding format may be set")


@dataclass(slots=True)
class SamplingParams:
    """Per-request sampling controls.

    Defaults mirror the reference: temperature=1.0, top_k=0 (disabled),
    top_p=1.0 (disabled) ⇒ greedy only when temperature==0 or top_k==1.
    The reference treats ``top_k=0, top_p=1, temperature=1`` as full
    multinomial sampling; greedy is requested via ``top_k=1``
    (reference: sampling_params.py:153-320, sampling_utils.py:39-47).
    """
    # Termination
    end_id: Optional[int] = None
    pad_id: Optional[int] = None
    max_tokens: int = 32
    min_tokens: int = 0
    stop: Optional[Union[str, List[str]]] = None
    stop_token_ids: Optional[List[int]] = None
    include_stop_str_in_output: bool = False
    ignore_eos: bool = False
    bad: Optional[Union[str, List[str]]] = None
    bad_token_ids: Optional[List[int]] = None

    # Core sampling
    n: int = 1
    best_of: Optional[int] = None
    use_beam_search: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    top_p_min: float = 0.0
    top_p_reset_ids: int = -1
    top_p_decay: float = 1.0
    min_p: float = 0.0
    seed: Optional[int] = None

    # Penalties
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    length_penalty: float = 1.0
    early_stopping: Union[bool, int] = True
    no_repeat_ngram_size: int = 0
    beam_search_diversity_rate: float = 0.0
    beam_width_array: Optional[List[int]] = None
    prompt_ignore_length: int = 0

    # Outputs
    logprobs: Optional[int] = None
    prompt_logprobs: Optional[int] = None
    logprobs_mode: LogprobsMode = LogprobsMode.PROCESSED
    return_context_logits: bool = False
    return_generation_logits: bool = False
    exclude_input_from_output: bool = True
    return_perf_metrics: bool = False
    additional_model_outputs: Optional[List[str]] = None

    # Processors / constraints
    logits_processor: Optional[Callable] = None
    embedding_bias: Optional[Any] = None
    guided_decoding: Optional[GuidedDecodingParams] = None

    # Tokenization behavior
    detokenize: bool = True
    add_special_tokens: bool = True
    truncate_prompt_tokens: Optional[int] = None
    skip_special_tokens: bool = True
    spaces_between_special_tokens: bool = True

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError("top_p must be in (0, 1]")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if self.best_of is None:
            self.best_of = self.n
        if self.best_of < self.n:
            raise ValueError("best_of must be >= n")
        if isinstance(self.stop, str):
            self.stop = [self.stop]
        if self.use_beam_search and self.best_of == 1:
            raise ValueError("beam search requires best_of > 1")

    # ------------------------------------------------------------------ #
    @property
    def beam_width(self) -> int:
        return self.best_of if self.use_beam_search else 1

    @property
    def greedy(self) -> bool:
        """Greedy iff argmax decoding is requested."""
        return (self.temperature == 0.0 or self.top_k == 1) and not self.use_beam_search

    @property
    def needs_penalties(self) -> bool:
        return (self.repetition_penalty != 1.0 or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0 or self.no_repeat_ngram_size > 0)

    def stop_id_list(self) -> list[int]:
        ids = list(self.stop_token_ids or ())
        if self.end_id is not None and not self.ignore_eos:
            ids.append(self.end_id)
        return ids
