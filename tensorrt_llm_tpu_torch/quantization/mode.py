"""Quantization algorithm names.

Port of the ``QuantAlgo`` / ``KvCacheQuantAlgo`` enums of
``tensorrt_llm_tpu/quantization/mode.py``. This package serves every
weight algorithm the JAX package serves (ops/linear.py: W8A16, W4A16,
W4A16_AWQ, W4A16_GPTQ, NVFP4, MXFP4, FP8, FP8_PER_CHANNEL_PER_TOKEN,
FP8_BLOCK_SCALES, W8A8_SQ_PER_CHANNEL(_PER_TOKEN_PLUGIN), W4A8_AWQ) and
every KV cache algorithm (INT8, FP8, NVFP4 on an e4m3 pool;
models/modeling_utils.py ModelConfig). W8A8_SQ_PER_TENSOR_PLUGIN and
MIXED_PRECISION, which the JAX factory refuses too, parse and are
refused by name.
"""
from __future__ import annotations

from enum import Enum


class QuantAlgo(str, Enum):
    """Weight/activation quantization algorithms."""
    NO_QUANT = "NO_QUANT"
    W8A16 = "W8A16"                       # int8 weight-only, per-channel
    W4A16 = "W4A16"                       # int4 weight-only, per-channel
    W4A16_AWQ = "W4A16_AWQ"               # int4 group-scaled (AWQ)
    W4A16_GPTQ = "W4A16_GPTQ"             # int4 group-scaled + zero points
    W4A8_AWQ = "W4A8_AWQ"
    W8A8_SQ_PER_CHANNEL = "W8A8_SQ_PER_CHANNEL"        # SmoothQuant
    W8A8_SQ_PER_TENSOR_PLUGIN = "W8A8_SQ_PER_TENSOR_PLUGIN"
    W8A8_SQ_PER_CHANNEL_PER_TOKEN_PLUGIN = "W8A8_SQ_PER_CHANNEL_PER_TOKEN_PLUGIN"
    FP8 = "FP8"                           # e4m3 per-tensor
    FP8_PER_CHANNEL_PER_TOKEN = "FP8_PER_CHANNEL_PER_TOKEN"
    FP8_BLOCK_SCALES = "FP8_BLOCK_SCALES"  # 1x128 / 128x128 (DeepSeek style)
    NVFP4 = "NVFP4"                       # 4-bit float w/ fp8 block scales
    MXFP4 = "MXFP4"
    MIXED_PRECISION = "MIXED_PRECISION"

    @property
    def is_weight_only(self) -> bool:
        return self in (QuantAlgo.W8A16, QuantAlgo.W4A16, QuantAlgo.W4A16_AWQ,
                        QuantAlgo.W4A16_GPTQ)

    @property
    def has_group_scales(self) -> bool:
        return self in (QuantAlgo.W4A16_AWQ, QuantAlgo.W4A16_GPTQ,
                        QuantAlgo.W4A8_AWQ, QuantAlgo.MXFP4, QuantAlgo.NVFP4)

    @property
    def has_zero_points(self) -> bool:
        return self == QuantAlgo.W4A16_GPTQ


class KvCacheQuantAlgo(str, Enum):
    NO_QUANT = "NO_QUANT"
    INT8 = "INT8"
    FP8 = "FP8"
    NVFP4 = "NVFP4"
