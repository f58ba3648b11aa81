"""tensorrt_llm_tpu_torch — the PyTorch + CUDA port of tensorrt_llm_tpu.

A second package beside the JAX one, with the same layout (llmapi/,
runtime/, models/, ops/) and names. Its kernels are written by hand for
NVIDIA Hopper (csrc/*.cu) and built with nvcc at first use. It imports
neither JAX nor the JAX package.
"""
from .llmapi.llm import LLM, RequestOutput
from .llmapi.llm_args import (KvCacheConfig, LlmArgs, MoeConfig,
                              QuantConfig, SparseAttentionConfig,
                              SpeculativeConfig)
from .models.convert import from_jax_params
from .quantization.mode import QuantAlgo
from .sampling_params import GuidedDecodingParams, SamplingParams

__all__ = ["LLM", "RequestOutput", "LlmArgs", "KvCacheConfig", "MoeConfig",
           "QuantConfig", "QuantAlgo", "SamplingParams", "SpeculativeConfig",
           "SparseAttentionConfig",
           "GuidedDecodingParams", "from_jax_params"]
