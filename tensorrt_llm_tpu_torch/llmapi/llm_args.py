"""Configuration tree for the LLM API.

Port of the subset of ``tensorrt_llm_tpu/llmapi/llm_args.py`` that the
serving path reads, weight-only quantization, the quantized KV cache,
the single-device MoE options and EAGLE3 speculative decoding included. Unknown keys are
rejected (so an option this package does not implement fails loudly
instead of being ignored).
"""
from __future__ import annotations

from typing import Any, List, Literal, Optional

from pydantic import BaseModel, Field, field_validator, model_validator

from ..ops.linear import check_ported
from ..quantization.mode import KvCacheQuantAlgo, QuantAlgo
from ..runtime.scheduler import CapacitySchedulerPolicy, ContextChunkingPolicy


class StrictBaseModel(BaseModel):
    model_config = dict(extra="forbid", validate_assignment=True,
                        arbitrary_types_allowed=True)


class KvCacheConfig(StrictBaseModel):
    enable_block_reuse: bool = True
    max_tokens: Optional[int] = None
    free_gpu_memory_fraction: float = Field(0.9, gt=0.0, le=1.0)
    event_buffer_max_size: int = 0
    tokens_per_block: int = 32
    # VSWA (Gemma 2): the smallest window of the list sizes the sliding
    # layers' own KV pool and is their window
    max_attention_window: Optional[List[int]] = None

    @field_validator("tokens_per_block")
    @classmethod
    def _power_of_two(cls, v: int) -> int:
        if v & (v - 1) or v <= 0:
            raise ValueError("tokens_per_block must be a power of 2")
        return v

    @field_validator("max_attention_window")
    @classmethod
    def _positive_windows(cls, v):
        if v is not None and (not v or min(v) <= 0):
            raise ValueError("max_attention_window must hold positive "
                             "window sizes")
        return v


class SchedulerConfig(StrictBaseModel):
    capacity_scheduler_policy: CapacitySchedulerPolicy = \
        CapacitySchedulerPolicy.GUARANTEED_NO_EVICT
    context_chunking_policy: ContextChunkingPolicy = \
        ContextChunkingPolicy.FIRST_COME_FIRST_SERVED
    waiting_queue_policy: Literal["fcfs", "priority"] = "fcfs"
    # cap on requests concurrently holding executor state; None = 4x
    # max_batch_size (waiting requests hold no KV/slots)
    max_active_requests: Optional[int] = None


class BucketingConfig(StrictBaseModel):
    """Token buckets: every step's ragged batch is padded up to the next
    bucket, so a later CUDA graph per bucket can replay it."""
    token_buckets: Optional[List[int]] = None

    def resolve_token_buckets(self, max_num_tokens: int) -> List[int]:
        if self.token_buckets:
            return sorted(set(min(t, max_num_tokens)
                              for t in self.token_buckets))
        buckets, t = [], 64
        while t < max_num_tokens:
            buckets.append(t)
            t *= 4
        buckets.append(max_num_tokens)
        return sorted(set(buckets))


class QuantConfig(StrictBaseModel):
    """Weight quantization: the algorithm, the group size of the
    group-wise ones (NVFP4 and MXFP4 fix their own), and name fragments of
    the projections that stay unquantized; and the KV cache's algorithm
    (every ``KvCacheQuantAlgo`` is served: INT8, FP8, and NVFP4 on an e4m3
    pool, models/modeling_utils.ModelConfig; any other name fails to
    parse). ``smoothquant_val``: SmoothQuant's alpha, the migration
    strength of the smoothing scales s = max|x|^alpha / max|w|^(1-alpha)
    (quantization/smoothquant.py), calibrated when the ``LLM`` is given a
    ``transformers`` module."""
    quant_algo: QuantAlgo = QuantAlgo.NO_QUANT
    kv_cache_quant_algo: KvCacheQuantAlgo = KvCacheQuantAlgo.NO_QUANT
    group_size: int = 128
    smoothquant_val: float = 0.5
    exclude_modules: List[str] = Field(default_factory=lambda: ["lm_head"])


class MoeConfig(StrictBaseModel):
    """The JAX package's MoE options, at their defaults only: the MoE
    block picks its route by the experts' type and device (ops/moe.py), so
    a ``backend`` other than "auto", a ``max_num_tokens`` chunk limit and
    the online expert load balancer (wide EP) are refused by name
    (``check_ported_moe``)."""
    backend: str = "auto"            # auto|megablox|dense|ragged
    max_num_tokens: Optional[int] = None
    load_balancer: Optional[dict] = None


class SpeculativeConfig(StrictBaseModel):
    """Umbrella for spec-decode modes: the JAX package's fields, defaults
    and meanings. This package serves ``mode="EAGLE3"`` with
    ``device_window=True`` and a linear draft chain, and the host drafters
    NGRAM, SA, AUTO, USER_PROVIDED, DRAFT_TARGET and PARD
    (``check_ported_spec``); every other mode or option is refused by
    name."""
    mode: Literal["NONE", "DRAFT_TARGET", "NGRAM", "EAGLE3", "MTP",
                  "SA", "AUTO", "PARD", "DFLASH", "USER_PROVIDED"] = "NONE"
    max_draft_len: int = 0
    # EAGLE3: checkpoint dir of *.safetensors, torch module, or None (a
    # random head); DRAFT_TARGET / PARD: checkpoint dir, torch module or a
    # bare PretrainedConfig (seeded random weights); USER_PROVIDED: a
    # Drafter
    draft_model: Optional[Any] = None
    # ngram
    ngram_max_matching_ngram_size: int = 4
    ngram_prompt_lookup_num_tokens: int = 4
    # PARD parallel draft: the draft model predicts all K drafts in one
    # forward over K mask tokens
    pard_mask_token_id: Optional[int] = None
    # suffix automaton: threshold suppresses weak matches
    sa_threshold: int = 2
    # auto-disable drafting above this many concurrently drafted rows
    max_concurrency: Optional[int] = None
    # EAGLE3/MTP: run propose->verify->accept fused on the device
    # (runtime/spec_window.py) so speculation rides the overlap
    # scheduler; False = host-orchestrated drafting (sync scheduler,
    # speculative/one_model.py)
    device_window: bool = True
    # spec iterations per fused dispatch (0 = derive from
    # decode_multi_step)
    device_window_iters: int = 0
    # EAGLE3 top-b TREE proposal: b nodes per level, max_draft_len//b
    # levels; 0 = linear chain
    eagle_tree_width: int = 0
    # dynamic tree: the final tree is the global top-max_draft_len cut
    # over the whole candidate pool by cumulative logprob
    eagle_dynamic_tree: bool = False


HOST_SPEC_MODES = ("NGRAM", "SA", "AUTO", "USER_PROVIDED", "DRAFT_TARGET",
                   "PARD")


def check_ported_spec(sc: Optional[SpeculativeConfig],
                      model_type: Optional[str] = None) -> None:
    """Refuse, by name, a speculative mode or option this package does
    not have, and (with ``model_type``) a target the mode cannot draft
    for: the EAGLE3 head reads the target's hidden rows, which the MoE
    (the DeepSeek-style families included), Gemma, LayerNorm GPT and
    Apertus forwards do not collect for it (nor do the JAX package's);
    the MTP head is an MLA layer that needs a DeepSeek-V3 / V2 target
    (the JAX package raises ValueError on any other, and on LongCat-Flash
    its forward fails: it collects no hidden rows). The host drafters
    need no hidden rows and take any target."""
    if sc is None or sc.mode == "NONE":
        return
    if model_type in VLM_MODEL_TYPES:
        raise NotImplementedError(
            f"speculative mode {sc.mode} with a {model_type} target is not "
            "supported by this package: a drafter sees the prompt's token "
            "ids, and an image's rows are one placeholder id repeated, not "
            "the features the target reads")
    if model_type in RECURRENT_MODEL_TYPES:
        raise NotImplementedError(
            f"speculative mode {sc.mode} with a {model_type} target is not "
            "supported by this package: a verify step writes every drafted "
            "token into the sequence's recurrent state, which cannot be "
            "rolled back as KV pages can (the JAX package's NGRAM on a "
            "Mamba target parts from greedy decoding at the first rejected "
            "draft)")
    if sc.mode == "DFLASH":
        raise NotImplementedError(
            "speculative mode DFLASH (the EAGLE head's block proposal) is "
            "not supported by this package yet (EAGLE3, MTP and the host "
            f"drafters {', '.join(HOST_SPEC_MODES)} are)")
    if sc.eagle_tree_width > 1:
        raise NotImplementedError(
            "speculative eagle_tree_width > 1 (EAGLE tree drafts) is not "
            "supported by this package yet")
    if sc.eagle_dynamic_tree:
        raise NotImplementedError(
            "speculative eagle_dynamic_tree (dynamic-tree drafts) is not "
            "supported by this package yet")
    if sc.mode in HOST_SPEC_MODES or model_type is None:
        return
    if sc.mode == "MTP":
        if model_type not in MTP_MODEL_TYPES:
            raise NotImplementedError(
                f"speculative mode MTP with a {model_type} target is not "
                "supported by this package: the MTP head needs an MLA "
                f"target ({', '.join(MTP_MODEL_TYPES)}); the JAX package "
                "raises ValueError without an MLA latent pool and fails "
                "on longcat_flash, whose forward collects no hidden rows")
        return
    if model_type in MOE_MODEL_TYPES + GEMMA_MODEL_TYPES + GPT_MODEL_TYPES \
            + ("apertus",):
        raise NotImplementedError(
            f"speculative mode {sc.mode} with a {model_type} target is not "
            "supported by this package (EAGLE3 drafts for the Llama and "
            "Qwen2/Qwen3 dense families)")


# the targets the MTP head drafts for (MLA latent pools)
MTP_MODEL_TYPES = ("deepseek_v3", "deepseek_v2")
# the recurrent families (models/recurrent.py), kept here so that the
# argument checks need not import the models
RECURRENT_MODEL_TYPES = ("mamba", "falcon_mamba", "mamba2", "bamba",
                         "jamba", "zamba2", "granitemoehybrid", "lfm2",
                         "qwen3_next", "minimax")
MOE_MODEL_TYPES = ("mixtral", "qwen2_moe", "qwen3_moe", "olmoe", "gpt_oss",
                   "granitemoe", "hunyuan_v1_moe", "glm4_moe", "ernie4_5_moe",
                   "deepseek_v2", "deepseek_v3", "longcat_flash")
GEMMA_MODEL_TYPES = ("gemma2", "gemma3_text")
# the splice-only vision-language models (multimodal/): image features
# replace the placeholder tokens' embeddings of a Llama trunk
VLM_MODEL_TYPES = ("llava", "llava_next", "mistral3", "internvl")
# the LayerNorm GPT families (models/gpt_family.py, gpt2.py), whose
# forward collects no hidden rows for an EAGLE3 head (nor does the JAX one)
GPT_MODEL_TYPES = ("gpt2", "gpt_neox", "gptj", "falcon", "starcoder2",
                   "cohere", "nemotron", "cohere2", "stablelm", "bloom",
                   "mpt", "opt")


def check_ported_moe(args: "LlmArgs") -> None:
    """Refuse, by name, the MoE options of the JAX package that need more
    than one device or its expert load balancer, or that this package
    would otherwise ignore."""
    for name in ("moe_tensor_parallel_size", "moe_expert_parallel_size"):
        if getattr(args, name) not in (-1, 1):
            raise NotImplementedError(
                f"{name}={getattr(args, name)}: MoE parallelism across "
                "devices is not supported by this package yet")
    mc = args.moe_config
    if mc.backend != "auto":
        raise NotImplementedError(
            f"moe_config.backend={mc.backend!r} is not supported by this "
            "package: the MoE route follows the experts' type and device "
            "(\"auto\")")
    if mc.max_num_tokens is not None:
        raise NotImplementedError(
            "moe_config.max_num_tokens (a per-call token chunk of the MoE "
            "block) is not supported by this package")
    if mc.load_balancer:
        raise NotImplementedError(
            "moe_config.load_balancer (the online wide-EP expert balancer) "
            "is not supported by this package")


class LlmArgs(StrictBaseModel):
    """Top-level engine arguments. ``model`` is a checkpoint directory or
    the name of an inline config (dummy weights)."""
    model: str
    skip_tokenizer_init: bool = False
    dtype: Literal["auto", "bfloat16", "float32"] = "auto"

    # engine limits
    max_batch_size: int = 64
    max_input_len: int = 2048
    max_seq_len: Optional[int] = None
    max_num_tokens: int = 4096

    kv_cache_config: KvCacheConfig = Field(default_factory=KvCacheConfig)
    scheduler_config: SchedulerConfig = Field(default_factory=SchedulerConfig)
    bucketing_config: BucketingConfig = Field(default_factory=BucketingConfig)
    quant_config: QuantConfig = Field(default_factory=QuantConfig)
    moe_config: MoeConfig = Field(default_factory=MoeConfig)
    speculative_config: Optional[SpeculativeConfig] = None
    # -1 = derived, as in the JAX package; on one device only 1 is served
    moe_tensor_parallel_size: int = -1
    moe_expert_parallel_size: int = -1

    enable_chunked_prefill: bool = True
    disable_overlap_scheduler: bool = False
    # widest beam a request may ask for; above 1 implies the sync
    # scheduler (beam re-ranking needs each step's logprobs before the
    # next step launches)
    max_beam_width: int = 1
    # decode steps allowed in flight before the host consumes results
    # (the overlap scheduler generalized to depth N)
    max_inflight_steps: int = 4
    # decode iterations per dispatched window: the engine loops K steps
    # on the device without a host sync; the host fetches once per K
    decode_multi_step: int = 8
    # context tokens carried per decode-window step (mixed window): each
    # of the K steps also prefills up to this many context tokens in the
    # same forward, so refill phases do not run prefill-only steps while
    # decode rows idle. 0 disables.
    mixed_window_ctx: int = Field(0, ge=0)
    # batching-wait: while context work is scheduled and the decode pool
    # is below this fraction of max_batch_size, decode rows sit out the
    # iteration so prefill refills the pool and windows run full. 0
    # disables (the latency-friendly default).
    decode_wait_occupancy: float = 0.0
    # TTFT budget: when a request that has not produced its first token
    # has waited longer than this, decode windows shrink to
    # decode_multi_step/4. 0 = off.
    ttft_slo_ms: float = 0.0
    # capture the serving CUDA graphs at engine build (the CUDA device
    # only); otherwise each is captured at its first step
    enable_warmup: bool = True
    load_format: Literal["auto", "dummy"] = "auto"
    stream_interval: int = 1
    # guided decoding (guided/): "dfa" walks the grammar on the device
    # (requests ride the overlap scheduler and K-step windows; the pool
    # holds TLLM_TPU_GUIDED_POOL_STATES states, 8,192 by default),
    # "dfa-host" masks each step from host matchers on the sync
    # scheduler; None serves no guided request
    guided_decoding_backend: Optional[Literal["dfa", "dfa-host"]] = None
    # without a tokenizer, each token's bytes: "decimal" (the token id's
    # decimal string: token-id-level grammars) or "byte" (token id ==
    # byte, EOS = token 0: byte-level checkpoints emit literal text)
    guided_token_bytes: Literal["decimal", "byte"] = "decimal"

    @model_validator(mode="after")
    def _fill_defaults(self):
        if self.max_seq_len is None:
            object.__setattr__(self, "max_seq_len", self.max_input_len + 2048)
        check_ported(self.quant_config.quant_algo)
        check_ported_spec(self.speculative_config)
        check_ported_moe(self)
        return self
