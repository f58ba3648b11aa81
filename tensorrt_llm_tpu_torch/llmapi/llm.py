"""The public ``LLM`` API.

Port of ``tensorrt_llm_tpu/llmapi/llm.py`` (``LLM.generate`` /
``generate_async`` / ``shutdown``, ``RequestOutput``): parse args, load the
model, build engine + executor, submit requests as futures.

``model`` is a checkpoint directory (``config.json`` +
``model.safetensors``; an AutoAWQ or AutoGPTQ 4-bit checkpoint of a dense
family is served from its own integers and scales), a ``transformers``
model (its ``state_dict`` is read, as the JAX ``LLM`` reads an inline
model; with ``load_format="dummy"`` seeded random weights instead), or a
bare ``transformers`` config, which serves random weights like
``load_format="dummy"``. Families (``model_type``): llama, mistral,
tinyllama, qwen2, qwen3, gemma2, gemma3_text, granite, olmo2, phi3, glm,
glm4, exaone4, smollm3, helium, arcee, hunyuan_v1_dense, seed_oss,
ernie4_5, apertus, the GPT families (models/gpt_family.py, gpt2.py),
deepseek_v2, deepseek_v3 and longcat_flash (MLA over a latent pool), and
the MoE families mixtral, qwen2_moe, qwen3_moe, olmoe, gpt_oss, granitemoe,
hunyuan_v1_moe, glm4_moe and ernie4_5_moe on one GPU, and the recurrent
families mamba, falcon_mamba, mamba2, bamba, jamba, zamba2,
granitemoehybrid, lfm2, qwen3_next and minimax (models/recurrent.py:
state pools indexed by sequence slot; no chunked prefill, no block
reuse, no speculation), the splice-only vision-language models llava,
llava_next, mistral3 and internvl (multimodal/: a vision tower and
projector in plain torch whose features replace the image placeholders'
embeddings over the Llama trunk), and ``bert`` (encoder-only: no KV pool,
no executor; ``LLM.classify``); the JAX package's other multimodal types
are refused by name.

A prompt is token ids, a string (with a tokenizer), or a dict as the JAX
``LLM`` takes it: ``prompt`` or ``prompt_token_ids``, with
``multi_modal_data`` ({"image": [...]}, the model's input processor:
placeholders expanded, features spliced, the images' hash joined to
``cache_salt`` so that equal text beside different images shares no KV
block), ``prompt_embeds`` (float32 [T, H], rows that are not NaN replace
their token's embedding) or ``prompt_tuning_config`` (an
``embedding_table`` whose rows the virtual ids vocab, vocab + 1, ...
take). Each sample of ``n > 1`` carries the embeddings too.
``kv_cache_config=KvCacheConfig(max_attention_window=[w, ...])`` serves
Gemma 2 with VSWA: its sliding layers keep their KV in a second pool
sized for the smallest window w, which is also their window (Gemma 3's
five-to-one layers raise the JAX package's ValueError; any other family
refuses the setting by name).
``quant_config=QuantConfig(quant_algo=...)`` quantizes float weights at
load (weight-only int, fp4, FP8 per-tensor or block, SmoothQuant W8A8,
W4A8). Under W8A8_SQ_PER_CHANNEL(_PER_TOKEN_PLUGIN) an inline
``transformers`` model is calibrated for SmoothQuant's smoothing scales
(``smoothquant_val`` is alpha; four seeded prompts of 64 tokens) before
its weights are read, as the JAX ``LLM`` does; the calibration forward
runs where the module lives, on its device and in its type (a bf16
module on the card calibrates in bf16 there), and the scales depend on
both. A checkpoint directory or a config gets no smoothing, as in the
JAX package. ``QuantConfig(kv_cache_quant_algo=INT8 | FP8 | NVFP4)`` keeps the KV
cache in int8 or float8 e4m3 (NVFP4: e4m3 on the e2m1 grid), with
per-layer scales calibrated at build over 512 seeded random tokens, as the
JAX ``LLM`` does when the checkpoint brings none.
``speculative_config=SpeculativeConfig(mode=..., max_draft_len=d,
draft_model=...)`` serves speculative decoding: ``"EAGLE3"`` and (on a
deepseek_v3 / deepseek_v2 target) ``"MTP"`` in the fused device window
(runtime/spec_window.py) or, with ``device_window=False``, on the sync
scheduler (speculative/one_model.py); ``draft_model`` a directory of
``*.safetensors`` head weights, a torch module whose ``state_dict`` holds
them, a mapping of checkpoint names to tensors, or None for the JAX
package's seeded random head; and on the sync scheduler with a host
drafter ``"NGRAM"``, ``"SA"``, ``"AUTO"`` (SA up to 8 rows, else
NGram), ``"USER_PROVIDED"`` (a ``Drafter`` in ``draft_model``, chain
drafts only), ``"DRAFT_TARGET"`` and ``"PARD"`` (``draft_model`` a
checkpoint directory, a torch module or a bare ``transformers`` config,
which gets seeded random weights; PARD's mask token from
``pard_mask_token_id`` or the draft config). The engine runs on the CUDA
device unless ``device="cpu"`` is passed; without CUDA and without that
argument, construction raises. On CUDA, ``enable_warmup`` (the default)
captures the serving CUDA graphs at build, as the JAX ``LLM`` compiles
its buckets at build on the TPU.

``SamplingParams`` as the JAX ``LLM`` serves them: ``n > 1`` samples
(each its own request sharing the prompt through the prefix cache, seeds
folded per sample), ``prompt_logprobs`` (one teacher-forced forward,
returned on ``RequestOutput.prompt_logprobs``), ``no_repeat_ngram_size``,
``bad_token_ids``, ``embedding_bias``, ``logits_processor`` (the sync
scheduler: ``disable_overlap_scheduler=True``) and beam search
(``use_beam_search`` with ``best_of`` beams; ``max_beam_width`` > 1
implies the sync scheduler), and ``guided_decoding`` (regex, JSON
schema, ``json_object``, EBNF grammar, structural tag) with
``guided_decoding_backend="dfa"`` (the grammar walk on the device, in
steps and K-step windows on the overlap scheduler) or ``"dfa-host"``
(host masks on the sync scheduler); without a tokenizer each token's
bytes follow ``guided_token_bytes``. Guided decoding is refused by name
with speculative decoding, with beam search and on an ``LLM`` built
without a guided backend.

``LLM.abort_request`` cancels a request, ``LLM.get_stats`` returns the
executor's per-iteration statistics, and a request whose own host work
fails (a logits processor that raises, a grammar that does not compile
or cannot fit the pool) fails alone while the loop serves on. An
out-of-memory error while the weights load, the KV pool is allocated or
the graphs are captured names that stage and its knob
(``_creation_stage``).
"""
from __future__ import annotations

import contextlib
import copy
import os
from pathlib import Path
from typing import Any, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..logger import logger
from ..models import ModelConfig, get_model_class
from ..quantization.checkpoint import (PrequantizedWeight,
                                       convert_state_dict,
                                       detect_prequantized)
from ..quantization.mode import QuantAlgo
from ..runtime.executor import GenerationResult, PyExecutor
from ..runtime.kv_cache_manager import KVCacheManager, VswaKvManager
from ..runtime.model_engine import ModelEngine
from ..runtime.request import LlmRequest
from ..runtime.scheduler import (CapacityScheduler, MicroBatchScheduler,
                                 RequestScheduler)
from ..sampling_params import SamplingParams
from .llm_args import MOE_MODEL_TYPES, LlmArgs, check_ported_spec

PromptInput = Union[str, Sequence[int], Mapping[str, Any]]


@contextlib.contextmanager
def _creation_stage(stage: str):
    """Stage-tagged OOM explanation at build (the JAX llm.py:36-47): an
    allocation failure names the stage and the knob that relieves it."""
    from ..runtime.error_isolation import classify_error, explain_stage_oom
    try:
        yield
    except Exception as e:
        if classify_error(str(e)) == "severe":
            raise RuntimeError(explain_stage_oom(stage, e)) from e
        raise

_DTYPES = {"auto": torch.bfloat16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


class RequestOutput:
    """Final result wrapper around one request's GenerationResult. May
    aggregate n > 1 parallel samples (``SamplingParams.n``): each sample
    is its own engine request sharing the prompt via the prefix cache,
    and sample j's outputs carry ``index`` j."""

    def __init__(self, result: GenerationResult, prompt: Optional[str],
                 extra_results: Optional[List[GenerationResult]] = None):
        self._result = result
        self._extra = extra_results or []
        self.prompt = prompt

    @property
    def request_id(self) -> int:
        return self._result.request_id

    @property
    def prompt_token_ids(self):
        return self._result.prompt_token_ids

    @property
    def prompt_logprobs(self):
        return self._result.prompt_logprobs

    @property
    def outputs(self):
        outs = list(self._result.outputs)
        for i, r in enumerate(self._extra):
            for o in r.outputs:
                o.index = i + 1
                outs.append(o)
        return outs

    @property
    def finished(self) -> bool:
        return self._result.finished and all(r.finished for r in self._extra)

    def result(self, timeout: Optional[float] = None) -> "RequestOutput":
        self._result.result(timeout)
        for r in self._extra:
            r.result(timeout)
        return self

    def __iter__(self):
        return iter(self._result)

    def __repr__(self):
        return (f"RequestOutput(request_id={self.request_id}, "
                f"outputs={self.outputs!r})")


def resolve_device(device: Optional[Union[str, torch.device]]
                   ) -> torch.device:
    """The CUDA device unless the caller names another; never a silent
    CPU fallback."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


class LLM:
    """End-user entry point."""

    def __init__(self, model: Any, tokenizer: Any = None,
                 device: Optional[Union[str, torch.device]] = None,
                 **kwargs):
        self.device = resolve_device(device)
        self._hf_config = None
        self._inline_model = None
        if isinstance(model, (str, Path)):
            kwargs["model"] = str(model)
        elif hasattr(model, "state_dict"):
            # a transformers model: its config and state dict
            self._inline_model = model
            self._hf_config = model.config
            kwargs["model"] = getattr(model.config, "name_or_path", "") or \
                "__inline__"
        else:
            # a bare transformers config: random weights
            self._hf_config = model
            kwargs["model"] = getattr(model, "name_or_path", "") or \
                "__inline_config__"
            kwargs["load_format"] = "dummy"
        self.args = LlmArgs(**kwargs)
        self.tokenizer = tokenizer
        self._build_model()
        if getattr(self.model, "is_encoder_only", False):
            # an encoder (BERT reranker): no KV pool, no executor, no
            # graphs; one bidirectional pass per classify() call (the JAX
            # llm.py:126-133)
            self._encoder_params = self._params
            del self._params
            self.executor = self.engine = None
            return
        from ..multimodal import create_input_processor
        self.input_processor = create_input_processor(self.model)
        self._build_executor()

    # ------------------------------------------------------------------ #
    # Build
    # ------------------------------------------------------------------ #
    def _build_model(self):
        hf_config, state_dict = self._load_checkpoint()
        model_config = ModelConfig(hf_config=hf_config,
                                   dtype=_DTYPES[self.args.dtype],
                                   device=self.device,
                                   quant_config=self.args.quant_config)
        check_ported_spec(self.args.speculative_config,
                          hf_config.model_type)
        self.model = get_model_class(hf_config.model_type)(model_config)
        if getattr(self.model, "has_recurrent_state", False):
            # a recurrent state is not addressable by block: no chunked
            # prefill and no prefix reuse (the JAX LLM, llm.py:174-178)
            self.args.enable_chunked_prefill = False
            self.args.kv_cache_config.enable_block_reuse = False
        maw = self.args.kv_cache_config.max_attention_window
        if maw:
            if not hasattr(self.model, "enable_vswa"):
                raise NotImplementedError(
                    "kv_cache_config.max_attention_window (VSWA) is served "
                    f"for Gemma 2 only, not for {hf_config.model_type}")
            # the smallest window sizes the sliding pool
            self.model.enable_vswa(min(maw))
        qc = self.args.quant_config
        if qc.quant_algo in (QuantAlgo.W8A8_SQ_PER_CHANNEL,
                             QuantAlgo.W8A8_SQ_PER_CHANNEL_PER_TOKEN_PLUGIN) \
                and state_dict is not None \
                and self._inline_model is not None:
            from ..quantization.smoothquant import (calibrate_smooth_scales,
                                                    default_calibration_ids)
            self.model.smooth_scales = calibrate_smooth_scales(
                self._inline_model,
                default_calibration_ids(self.model.vocab_size),
                alpha=qc.smoothquant_val)
        with _creation_stage("weights"):
            if state_dict is None:
                self._params = self.model.init_params(seed=0)
            else:
                self._params = self.model.load_hf_state_dict(state_dict)

    def _load_checkpoint(self):
        if self._inline_model is not None:
            if self.args.load_format == "dummy":
                return self._hf_config, None
            return self._hf_config, {
                k: v.detach()
                for k, v in self._inline_model.state_dict().items()}
        if self._hf_config is not None:
            return self._hf_config, None
        path = Path(self.args.model)
        if not path.exists():
            raise FileNotFoundError(
                f"model path {path} not found (pass a local checkpoint "
                f"directory or a transformers config)")
        from transformers import AutoConfig
        hf_config = AutoConfig.from_pretrained(path)
        if self.tokenizer is None and not self.args.skip_tokenizer_init:
            try:
                from transformers import AutoTokenizer
                self.tokenizer = AutoTokenizer.from_pretrained(path)
            except (OSError, ValueError) as e:
                logger.warning("tokenizer load failed: %s", e)
        if self.args.load_format == "dummy":
            return hf_config, None
        from safetensors.torch import load_file
        files = sorted(path.glob("*.safetensors"))
        if not files:
            raise FileNotFoundError(f"no *.safetensors under {path}")
        sd = {}
        for f in files:
            sd.update(load_file(str(f)))
        # a prequantized checkpoint (AutoAWQ / AutoGPTQ) brings its own
        # recipe: adopt it and unpack its integer weights
        pq = detect_prequantized(path)
        if pq is not None and hf_config.model_type in MOE_MODEL_TYPES:
            raise NotImplementedError(
                f"a prequantized ({pq.quant_algo.value}) "
                f"{hf_config.model_type} checkpoint is not supported by "
                "this package (MoE experts are served in the model's type)")
        if pq is not None:
            qc = self.args.quant_config
            if qc.quant_algo not in (QuantAlgo.NO_QUANT, pq.quant_algo):
                logger.warning(
                    "quant_config %s overridden by the checkpoint's own %s",
                    qc.quant_algo.value, pq.quant_algo.value)
            qc.quant_algo = pq.quant_algo
            qc.group_size = pq.group_size
            qc.exclude_modules = sorted(set(qc.exclude_modules) |
                                        set(pq.exclude_modules))
            sd = convert_state_dict(sd, pq)
            logger.info("ingested prequantized checkpoint: %s group=%d "
                        "(%d quantized tensors)", pq.quant_algo.value,
                        pq.group_size,
                        sum(isinstance(v, PrequantizedWeight)
                            for v in sd.values()))
        return hf_config, sd

    def _build_host_drafter(self):
        """(host drafter, drafts per verify step) of the modes that draft
        on the sync scheduler (the JAX ``LLM._build_executor``, llm.py:
        323-403: EAGLE3 and MTP with ``device_window=False`` among them),
        or (None, 0). Built before the engine, so that the draft model's
        weights and pool are on the device before the target's pool is
        sized from free memory."""
        sc = self.args.speculative_config
        if sc is None or sc.mode == "NONE" or \
                (sc.mode in ("EAGLE3", "MTP") and sc.device_window):
            return None, 0
        d = sc.max_draft_len or 4
        if sc.mode in ("EAGLE3", "MTP"):
            drafter = self._build_one_model_head(
                max_slots=min(32, self.args.max_batch_size))
        elif sc.mode == "USER_PROVIDED":
            drafter = sc.draft_model
            if not callable(getattr(drafter, "prepare_draft_tokens", None)):
                raise ValueError("USER_PROVIDED needs a Drafter in "
                                 "speculative_config.draft_model")
            drafter.max_draft_len = d
        elif sc.mode == "AUTO":
            # a model-free scheme sized by the batch: the suffix automaton
            # at small batch, NGram's bounded lookup beyond
            from ..speculative.ngram import NGramDrafter
            from ..speculative.suffix_automaton import SuffixAutomatonDrafter
            if self.args.max_batch_size <= 8:
                drafter = SuffixAutomatonDrafter(
                    max_draft_len=d, threshold=sc.sa_threshold,
                    max_concurrency=sc.max_concurrency or 32)
            else:
                drafter = NGramDrafter(max_draft_len=d,
                                       max_matching_ngram_size=5)
        elif sc.mode == "SA":
            from ..speculative.suffix_automaton import SuffixAutomatonDrafter
            drafter = SuffixAutomatonDrafter(
                max_draft_len=d, threshold=sc.sa_threshold,
                max_concurrency=sc.max_concurrency)
        elif sc.mode == "NGRAM":
            from ..speculative.ngram import NGramDrafter
            drafter = NGramDrafter(
                max_draft_len=d,
                max_matching_ngram_size=sc.ngram_max_matching_ngram_size)
        else:                                   # DRAFT_TARGET, PARD
            drafter = self._build_two_model_drafter(sc, d)
        return drafter, drafter.max_draft_len

    def _build_two_model_drafter(self, sc, max_draft_len: int):
        """The draft model of DRAFT_TARGET / PARD (the JAX
        ``_build_two_model_drafter``, llm.py:274-320): a checkpoint
        directory, a torch module, or a bare ``transformers`` config whose
        weights are drawn from a seeded ``torch.Generator`` (seed 1)."""
        from ..speculative.model_drafter import TwoModelDrafter
        dm = sc.draft_model
        if dm is None:
            raise ValueError("DRAFT_TARGET needs speculative_config."
                             "draft_model")
        if isinstance(dm, (str, Path)):
            from safetensors.torch import load_file
            from transformers import AutoConfig
            path = Path(dm)
            hf_config = AutoConfig.from_pretrained(path)
            sd = {}
            for f in sorted(path.glob("*.safetensors")):
                sd.update(load_file(str(f)))
            sd = sd or None
        elif hasattr(dm, "state_dict"):
            hf_config = dm.config
            sd = {k: v.detach().cpu().float()
                  for k, v in dm.state_dict().items()}
        else:                      # a bare config: seeded random weights
            hf_config, sd = dm, None
        model = get_model_class(hf_config.model_type)(ModelConfig(
            hf_config=hf_config, dtype=_DTYPES[self.args.dtype],
            device=self.device))
        params = model.load_hf_state_dict(sd) if sd is not None \
            else model.init_params(seed=1)
        mask_id = sc.pard_mask_token_id
        if sc.mode == "PARD" and mask_id is None:
            mask_id = getattr(hf_config, "mask_token_id", None) or \
                getattr(hf_config, "pard_token", None)
            if mask_id is None:
                raise ValueError(
                    "PARD needs pard_mask_token_id (or a draft config "
                    "carrying mask_token_id/pard_token)")
        return TwoModelDrafter(
            model, params, max_draft_len=max_draft_len,
            max_slots=min(64, self.args.max_batch_size),
            max_seq_len=self.args.max_seq_len,
            parallel_draft=sc.mode == "PARD", mask_token_id=int(mask_id or 0))

    def _build_spec_head(self):
        """The EAGLE3 or MTP head of the fused window, or None without
        one. Built before the engine, so that the head's weights are on
        the device before the target's pool is sized from free memory
        (the engine counts the head's pool off it, ``spec_state_bytes``)."""
        sc = self.args.speculative_config
        if sc is None or sc.mode not in ("EAGLE3", "MTP") or \
                not sc.device_window:
            return None
        return self._build_one_model_head(max_slots=0)

    def _build_one_model_head(self, max_slots: int):
        """An EAGLE3 or MTP head (the JAX llm.py:372-403). Its weights come
        from ``draft_model``: a directory of ``*.safetensors``, a torch
        module whose ``state_dict`` holds them, or a mapping of
        checkpoint names to tensors (read as the loader asks for each;
        ``models.recurrent.RandomCheckpoint`` draws seeded random ones on
        the device); without them, the JAX package's seeded random head.
        ``max_slots`` > 0: the host path's own pool of that many slots."""
        sc = self.args.speculative_config
        head_sd = None
        if isinstance(sc.draft_model, (str, Path)):
            from safetensors.torch import load_file
            head_sd = {}
            for f in sorted(Path(sc.draft_model).glob("*.safetensors")):
                head_sd.update(load_file(str(f)))
        elif sc.draft_model is not None and \
                hasattr(sc.draft_model, "state_dict"):
            head_sd = {k: v.detach().cpu().float()
                       for k, v in sc.draft_model.state_dict().items()}
        elif isinstance(sc.draft_model, Mapping):
            head_sd = sc.draft_model
        if sc.mode == "MTP":
            from ..speculative.mtp import MtpDrafter as cls
        else:
            from ..speculative.eagle import Eagle3Drafter as cls
        return cls(self.model, self._params,
                   max_draft_len=sc.max_draft_len or 4, max_slots=max_slots,
                   max_seq_len=self.args.max_seq_len,
                   head_state_dict=head_sd)

    def _build_guided_decoder(self):
        """(guided decoder, device pool states) as the JAX ``LLM`` builds
        them (llm.py:545-575), or (None, 0) without a guided backend. The
        token table comes from the tokenizer, else from
        ``guided_token_bytes``: "byte" (ids below 256 are their byte,
        EOS is token 0), "decimal" (each id's decimal string, EOS 0)."""
        from ..guided.grammar_matcher import TokenTable
        from ..guided.guided_decoder import GuidedDecoder
        args = self.args
        if not args.guided_decoding_backend:
            return None, 0
        V = self.model.vocab_size
        if self.tokenizer is not None:
            table = TokenTable.from_tokenizer(self.tokenizer)
        elif args.guided_token_bytes == "byte":
            table = TokenTable([bytes([i]) for i in range(min(V, 256))] +
                               [b""] * max(0, V - 256), eos_token_id=0)
        else:
            table = TokenTable([str(i) for i in range(V)], eos_token_id=0)
        pool = 0
        if args.guided_decoding_backend == "dfa":
            pool = int(os.environ.get("TLLM_TPU_GUIDED_POOL_STATES", "8192"))
        return GuidedDecoder(table, args.max_batch_size), pool

    def _build_executor(self):
        args = self.args
        host_drafter, d = self._build_host_drafter()
        head = self._build_spec_head()
        guided, pool_states = self._build_guided_decoder()
        with _creation_stage("kv_pool"):
            # the guided pool is allocated first, so the KV pool's sizing
            # from free memory counts it off
            self.engine = ModelEngine(self.model, self._params, args,
                                      max_draft_len=d,
                                      guided_pool_states=pool_states)
        if pool_states:
            guided.attach_engine(self.engine, pool_states)
        if self.model.config.uses_kv_quant:
            # no checkpoint brings KV scales: calibrate them from one
            # prefill pass over the JAX LLM's tokens (llm.py:459-470),
            # before any graph is captured
            rng = np.random.default_rng(0)
            self.engine.calibrate_kv_scales(rng.integers(
                1, max(2, self.model.vocab_size - 1), size=512))
        del self._params
        if head is not None:
            # device windows verify inside the fused window; the plain
            # step stays single-logit
            from ..runtime.spec_window import enable_spec_device
            d = head.max_draft_len
            K = args.speculative_config.device_window_iters or max(
                1, args.decode_multi_step // (d + 1))
            enable_spec_device(self.engine, head, d, K)
        if args.enable_warmup and self.device.type == "cuda":
            with _creation_stage("warmup"):
                self.engine.warmup()
        # a single sequence can never exceed the KV pool
        pool_tokens = self.engine.num_kv_pages * \
            args.kv_cache_config.tokens_per_block
        if pool_tokens < args.max_seq_len:
            logger.warning(
                "KV pool (%d tokens) is smaller than max_seq_len (%d); "
                "clamping max_seq_len to the pool capacity",
                pool_tokens, args.max_seq_len)
            args.max_seq_len = pool_tokens
        self.kv_cache_manager = KVCacheManager(
            num_blocks=self.engine.num_kv_pages,
            tokens_per_block=args.kv_cache_config.tokens_per_block,
            max_seq_len=args.max_seq_len,
            enable_block_reuse=args.kv_cache_config.enable_block_reuse,
            event_buffer_max_size=args.kv_cache_config.event_buffer_max_size)
        if self.engine._vswa:
            self.kv_cache_manager = VswaKvManager(
                self.kv_cache_manager, KVCacheManager(
                    num_blocks=self.engine.num_sw_pages,
                    tokens_per_block=args.kv_cache_config.tokens_per_block,
                    max_seq_len=args.max_seq_len, enable_block_reuse=False,
                    ids_attr="kv_block_ids_sw"),
                window=self.model.vswa_window)
        capacity = CapacityScheduler(
            max_num_requests=args.max_batch_size,
            kv_cache_manager=self.kv_cache_manager,
            policy=args.scheduler_config.capacity_scheduler_policy)
        micro = MicroBatchScheduler(
            max_batch_size=args.max_batch_size,
            max_num_tokens=args.max_num_tokens,
            enable_chunked_prefill=args.enable_chunked_prefill,
            chunking_policy=args.scheduler_config.context_chunking_policy,
            chunk_unit_size=args.kv_cache_config.tokens_per_block)
        self.executor = PyExecutor(
            self.engine, self.kv_cache_manager,
            RequestScheduler(capacity, micro),
            tokenizer=self.tokenizer,
            enable_overlap=(not args.disable_overlap_scheduler
                            and args.max_beam_width <= 1),
            stream_interval=args.stream_interval,
            pipeline_depth=args.max_inflight_steps,
            decode_multi_step=args.decode_multi_step,
            waiting_queue_policy=args.scheduler_config.waiting_queue_policy,
            max_active_requests=args.scheduler_config.max_active_requests,
            decode_wait_occupancy=args.decode_wait_occupancy,
            ttft_slo_ms=args.ttft_slo_ms,
            drafter=head if host_drafter is None else host_drafter,
            guided_decoder=guided)

    # ------------------------------------------------------------------ #
    # Generation
    # ------------------------------------------------------------------ #
    def generate(self,
                 prompts: Union[PromptInput, Sequence[PromptInput]],
                 sampling_params: Optional[Union[SamplingParams,
                                                 List[SamplingParams]]] = None
                 ) -> Union[RequestOutput, List[RequestOutput]]:
        single = isinstance(prompts, (str, Mapping)) or (
            isinstance(prompts, Sequence) and prompts and
            isinstance(prompts[0], int))
        batch = [prompts] if single else list(prompts)
        if isinstance(sampling_params, SamplingParams) or \
                sampling_params is None:
            sp_list = [sampling_params] * len(batch)
        else:
            sp_list = list(sampling_params)
        futures = [self.generate_async(p, sp)
                   for p, sp in zip(batch, sp_list)]
        results = [f.result() for f in futures]
        return results[0] if single else results

    def generate_async(self,
                       prompt: PromptInput,
                       sampling_params: Optional[SamplingParams] = None,
                       streaming: bool = False,
                       cache_salt: Optional[str] = None) -> RequestOutput:
        # per-request clamps land on a private copy: generate() shares one
        # SamplingParams across every prompt of a batch
        sampling_params = copy.copy(sampling_params) if sampling_params \
            else SamplingParams()
        prompt_embeds = mm_data = ptuning = None
        if isinstance(prompt, Mapping):
            mm_data = prompt.get("multi_modal_data")
            prompt_embeds = prompt.get("prompt_embeds")
            ptuning = prompt.get("prompt_tuning_config")
            prompt = prompt.get("prompt", prompt.get("prompt_token_ids"))
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("string prompt requires a tokenizer")
            token_ids = self.tokenizer.encode(
                prompt, add_special_tokens=sampling_params.add_special_tokens)
            prompt_text = prompt
        else:
            token_ids = list(prompt)
            prompt_text = None
        if sampling_params.truncate_prompt_tokens:
            token_ids = token_ids[-sampling_params.truncate_prompt_tokens:]
        if len(token_ids) > self.args.max_input_len:
            raise ValueError(
                f"prompt length {len(token_ids)} exceeds max_input_len "
                f"{self.args.max_input_len}")
        if mm_data is not None:
            token_ids, prompt_embeds, cache_salt = self._multimodal(
                token_ids, mm_data, cache_salt)
        if ptuning is not None:
            token_ids, prompt_embeds, cache_salt = self._prompt_table(
                token_ids, prompt_embeds, ptuning, cache_salt)
        if prompt_embeds is not None:
            prompt_embeds = self._check_embeds(prompt_embeds, token_ids,
                                               sampling_params)
        room = self.args.max_seq_len - len(token_ids)
        if room < 1:
            raise ValueError("prompt leaves no room for generation within "
                             f"max_seq_len {self.args.max_seq_len}")
        sampling_params.max_tokens = min(sampling_params.max_tokens, room)
        if sampling_params.end_id is None and self.tokenizer is not None:
            eos = getattr(self.tokenizer, "eos_token_id", None)
            if eos is not None:
                sampling_params.end_id = eos
        req = LlmRequest(prompt_token_ids=token_ids,
                         sampling_params=sampling_params,
                         streaming=streaming, cache_salt=cache_salt,
                         prompt_embeds=prompt_embeds)
        res = self.executor.submit(req)
        extra = []
        if sampling_params.n > 1 and not sampling_params.use_beam_search:
            for j in range(1, sampling_params.n):
                sib = copy.copy(sampling_params)
                # the prompt's logprobs come with the first sample
                sib.prompt_logprobs = None
                if sib.seed:
                    # seeded noise is a function of (seed, position):
                    # fold the sample index into each sibling's seed so
                    # that the samples part deterministically
                    sib.seed = (sampling_params.seed * 0x9E3779B1
                                + j) & 0x7FFFFFFF or 1
                # each sample carries the prompt's embeddings (the JAX
                # LLM submits its siblings without them, llm.py:844-866,
                # so they decode the placeholders' own embeddings)
                extra.append(self.executor.submit(LlmRequest(
                    prompt_token_ids=list(token_ids), sampling_params=sib,
                    cache_salt=cache_salt, prompt_embeds=prompt_embeds)))
        return RequestOutput(res, prompt_text, extra_results=extra)

    def _multimodal(self, token_ids: List[int], mm_data: Mapping,
                    cache_salt: Optional[str]):
        """(expanded token ids, prompt embeddings on the device, salt) of
        a prompt with ``multi_modal_data``: the model's input processor
        expands the image placeholders and runs the vision tower and
        projector here, on the caller's thread, holding the engine's graph
        lock so that no CUDA graph capture on the executor thread sees
        its launches; the images' hash joins ``cache_salt`` (the JAX
        llm.py:762-777)."""
        if self.input_processor is None:
            raise ValueError(f"model {type(self.model).__name__} has no "
                             "multimodal input processor")
        with self.engine.graphs.lock:
            token_ids, embeds, salt = self.input_processor(token_ids,
                                                           mm_data)
        if len(token_ids) > self.args.max_input_len:
            raise ValueError(
                f"prompt with expanded image tokens ({len(token_ids)}) "
                f"exceeds max_input_len {self.args.max_input_len}")
        return token_ids, embeds, (cache_salt or "") + salt

    def _prompt_table(self, token_ids: List[int], prompt_embeds, ptuning,
                      cache_salt: Optional[str]):
        """Prompt tuning (the JAX llm.py:780-809): the virtual ids
        [vocab, vocab + rows) take rows of the request's
        ``embedding_table`` through the prompt-embedding path (their ids
        become 0, which only keys reuse), and the table's hash joins
        ``cache_salt``."""
        import hashlib
        table = ptuning["embedding_table"] if isinstance(ptuning, Mapping) \
            else ptuning.embedding_table
        table = np.asarray(table.detach().cpu() if isinstance(
            table, torch.Tensor) else table, np.float32)
        vocab = self.model.vocab_size
        token_ids = list(token_ids)
        if prompt_embeds is None:
            embeds = np.full((len(token_ids), table.shape[1]), np.nan,
                             np.float32)
        else:
            embeds = np.array(prompt_embeds.cpu() if isinstance(
                prompt_embeds, torch.Tensor) else prompt_embeds, np.float32)
        for i, t in enumerate(token_ids):
            if t < vocab:
                continue
            if t - vocab >= table.shape[0]:
                raise ValueError(
                    f"virtual token {t} outside the prompt table "
                    f"({table.shape[0]} rows from id {vocab})")
            embeds[i, :table.shape[1]] = table[t - vocab]
            token_ids[i] = 0
        salt = hashlib.sha256(table.tobytes()).hexdigest()[:16]
        return token_ids, embeds, (cache_salt or "") + salt

    def _check_embeds(self, prompt_embeds, token_ids: List[int],
                      sp: SamplingParams) -> torch.Tensor:
        """A request's prompt embeddings as float32 [T, H] on the device,
        with the refusals of their path: ``prompt_logprobs`` (the JAX
        ValueError, llm.py:812-818), beam search and speculative decoding
        (by name: neither the beam rows nor a drafter take embeddings)."""
        if sp.prompt_logprobs is not None:
            raise ValueError("prompt_logprobs is unsupported with "
                             "multimodal / prompt-embeds inputs")
        if sp.use_beam_search:
            raise NotImplementedError(
                "beam search with multimodal / prompt-embeds inputs is not "
                "supported by this package")
        sc = self.args.speculative_config
        if sc is not None and sc.mode != "NONE":
            raise NotImplementedError(
                f"speculative mode {sc.mode} with multimodal / "
                "prompt-embeds inputs is not supported by this package: a "
                "drafter sees token ids, not the embeddings")
        e = torch.as_tensor(prompt_embeds.detach() if isinstance(
            prompt_embeds, torch.Tensor) else np.asarray(
                prompt_embeds, np.float32))
        if e.dim() != 2 or e.shape[0] != len(token_ids):
            raise ValueError(f"prompt_embeds of shape {tuple(e.shape)} do "
                             f"not cover the {len(token_ids)} prompt tokens")
        return e.to(device=self.device, dtype=torch.float32)

    def classify(self, prompts, token_type_ids=None) -> np.ndarray:
        """Encoder-only scoring (the JAX llm.py:898-906): lists of token
        ids (or one list) -> float32 [B, num_labels] logits."""
        if not getattr(self.model, "is_encoder_only", False):
            raise ValueError("classify() requires an encoder-only model")
        if prompts and isinstance(prompts[0], int):
            prompts = [prompts]
        return self.model.classify(self._encoder_params, prompts,
                                   token_type_ids)

    def abort_request(self, request_id: int) -> None:
        """Cancel a request: it ends CANCELLED with the tokens it has."""
        self.executor.cancel(request_id)

    def get_stats(self) -> list:
        """The executor's ``IterationStats``, oldest first (the last
        1,000 iterations)."""
        return list(self.executor.stats_history)

    # ------------------------------------------------------------------ #
    def shutdown(self):
        if getattr(self, "executor", None) is not None:
            self.executor.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # interpreter teardown: nothing left to report
            pass
