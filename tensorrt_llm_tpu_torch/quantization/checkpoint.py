"""Prequantized-checkpoint ingestion: AutoAWQ and AutoGPTQ containers.

This package's own copy of ``tensorrt_llm_tpu/quantization/checkpoint.py``
(host-side numpy; nothing is imported from the JAX package). Instead of
re-quantizing float weights at load, it unpacks the checkpoint's own
integer weights, scales and zero points into the engine's group-wise
representation, so dequantization reproduces the published math:

    w = (q - z) * s        q, z unsigned 4-bit, s per (group, out column)

Container formats:
  * AutoAWQ "gemm" (HF ``quantization_config.quant_method == "awq"``):
      qweight i32[K, N/8] nibble-interleaved order [0,2,4,6,1,3,5,7],
      qzeros  i32[K/G, N/8] same packing, scales f16[K/G, N].
  * AutoGPTQ (``quant_method == "gptq"``), 4-bit:
      qweight i32[K/8, N] sequential nibbles along K,
      qzeros  i32[K/G, N/8] sequential nibbles along N, stored as z-1
      (``checkpoint_format: gptq_v2`` stores z itself),
      scales f16[K/G, N]; act-order (g_idx) is refused.

ModelOpt containers (``hf_quant_config.json``: fp8 per-tensor, NVFP4,
per-layer KV scaling factors) and 8-bit GPTQ are not ingested yet: such a
checkpoint is refused with a plain error.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, List, Mapping, Optional

import numpy as np

from ..logger import logger
from .mode import QuantAlgo

# AutoAWQ nibble interleave: packed nibble i holds logical column
# col*8 + AWQ_ORDER[i] (WQLinear_GEMM.from_linear pack loop)
AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


@dataclasses.dataclass
class PrequantizedWeight:
    """A checkpoint-quantized projection already in the engine's internal
    groupwise layout: ``weight`` i8[K, N] (raw quantized values),
    ``weight_scale`` f32[K/G, N], ``weight_zero`` f32[K/G, N] or None
    (dequant: (q - z) * s — matches ops/quant.dequantize_weight)."""
    weight: np.ndarray
    weight_scale: np.ndarray
    weight_zero: Optional[np.ndarray] = None
    group_size: int = 128
    bits: int = 4


@dataclasses.dataclass
class PrequantConfig:
    """What the checkpoint says about its own quantization."""
    fmt: str                                   # awq | gptq
    quant_algo: Optional[QuantAlgo]
    group_size: int = 128
    has_zero_point: bool = True
    gptq_v2: bool = False                      # zeros stored without -1
    exclude_modules: List[str] = dataclasses.field(default_factory=list)


def detect_prequantized(path) -> Optional[PrequantConfig]:
    """Look for an HF ``quantization_config`` block in ``config.json``
    and describe the checkpoint format (None: not prequantized). A
    ModelOpt ``hf_quant_config.json`` is refused."""
    path = Path(path)
    if (path / "hf_quant_config.json").exists():
        raise NotImplementedError(
            f"{path}: ModelOpt checkpoints (hf_quant_config.json: fp8, "
            "NVFP4, KV scaling factors) are not ingested by this package "
            "yet")
    cfg_file = path / "config.json"
    if not cfg_file.exists():
        return None
    qc = json.loads(cfg_file.read_text()).get("quantization_config")
    if not qc:
        return None
    method = (qc.get("quant_method") or "").lower()
    bits = int(qc.get("bits", 4))
    if method == "awq":
        if (qc.get("version") or "gemm").lower() not in ("gemm", "gemv"):
            raise NotImplementedError(
                f"AWQ version {qc.get('version')!r} not supported "
                "(gemm/gemv packing only)")
        if bits != 4:
            raise NotImplementedError("AWQ ingestion supports 4-bit only")
        return PrequantConfig(
            fmt="awq", quant_algo=QuantAlgo.W4A16_AWQ,
            group_size=int(qc.get("group_size", 128)),
            has_zero_point=bool(qc.get("zero_point", True)),
            exclude_modules=qc.get("modules_to_not_convert") or [])
    if method == "gptq":
        if qc.get("desc_act"):
            raise NotImplementedError(
                "GPTQ act-order (desc_act=True) checkpoints are not "
                "supported: reorder offline with desc_act=False")
        if bits != 4:
            raise NotImplementedError("GPTQ ingestion supports 4-bit only")
        return PrequantConfig(
            fmt="gptq", quant_algo=QuantAlgo.W4A16_GPTQ,
            group_size=int(qc.get("group_size", 128)),
            has_zero_point=True,
            gptq_v2=(qc.get("checkpoint_format") == "gptq_v2"))
    logger.warning("quantization_config method %r not supported; "
                   "loading will fail unless weights are full-precision",
                   method)
    return None


# --------------------------------------------------------------------- #
# Unpackers
# --------------------------------------------------------------------- #
def _unpack_nibbles_i32(packed: np.ndarray) -> np.ndarray:
    """i32[..., W] -> u8[..., W, 8] of nibbles (LSB nibble first)."""
    shifts = np.arange(0, 32, 4, dtype=np.uint32)
    u = packed.astype(np.uint32)
    return ((u[..., None] >> shifts) & 0xF).astype(np.uint8)


def unpack_awq_gemm(qweight: np.ndarray, qzeros: np.ndarray,
                    scales: np.ndarray, group_size: int
                    ) -> PrequantizedWeight:
    """AutoAWQ WQLinear_GEMM tensors -> internal groupwise layout."""
    qweight, qzeros, scales = (np.asarray(a)    # arrays or CPU tensors
                               for a in (qweight, qzeros, scales))
    K = qweight.shape[0]
    nib = _unpack_nibbles_i32(qweight)            # [K, N/8, 8] nibble i
    N = nib.shape[1] * 8
    w = np.empty((K, nib.shape[1], 8), np.uint8)
    w[:, :, AWQ_ORDER] = nib                      # logical col order
    w = w.reshape(K, N)
    znib = _unpack_nibbles_i32(qzeros)            # [K/G, N/8, 8]
    z = np.empty_like(znib)
    z[:, :, AWQ_ORDER] = znib
    z = z.reshape(qzeros.shape[0], N)
    return PrequantizedWeight(
        weight=w.astype(np.int8),
        weight_scale=scales.astype(np.float32),
        weight_zero=z.astype(np.float32),
        group_size=group_size, bits=4)


def unpack_gptq(qweight: np.ndarray, qzeros: np.ndarray,
                scales: np.ndarray, group_size: int, v2: bool = False
                ) -> PrequantizedWeight:
    """AutoGPTQ 4-bit tensors -> internal groupwise layout."""
    qweight, qzeros, scales = (np.asarray(a)    # arrays or CPU tensors
                               for a in (qweight, qzeros, scales))
    nib = _unpack_nibbles_i32(qweight)            # [K/8, N, 8]
    K = qweight.shape[0] * 8
    w = nib.transpose(0, 2, 1).reshape(K, qweight.shape[1])
    znib = _unpack_nibbles_i32(qzeros)            # [K/G, N/8, 8]
    z = znib.reshape(qzeros.shape[0], -1).astype(np.int32)
    if not v2:
        # classic AutoGPTQ stores zero-1
        z = z + 1
    return PrequantizedWeight(
        weight=w.astype(np.int8),
        weight_scale=scales.astype(np.float32),
        weight_zero=z.astype(np.float32),
        group_size=group_size, bits=4)


def dequantize_prequant(pq: PrequantizedWeight,
                        dtype=np.float32) -> np.ndarray:
    """Reference host dequantization (used by the tests)."""
    K, N = pq.weight.shape
    G = pq.group_size
    qg = pq.weight.astype(np.float32).reshape(K // G, G, N)
    if pq.weight_zero is not None:
        qg = qg - pq.weight_zero[:, None, :]
    return (qg * pq.weight_scale[:, None, :]).reshape(K, N).astype(dtype)


# --------------------------------------------------------------------- #
# State-dict conversion
# --------------------------------------------------------------------- #
def convert_state_dict(sd: Mapping[str, Any],
                       cfg: PrequantConfig) -> Mapping[str, Any]:
    """A view of a prequantized state dict in which each
    ``<name>.weight`` entry is a :class:`PrequantizedWeight`, unpacked
    when it is looked up (the model loaders pass these through
    ``models.modeling_utils.quantize_linear`` untouched). Other entries
    pass through as they are; nothing is read before a lookup."""
    from .lazy_state_dict import RenamedStateDict
    computed = {}
    done = set()
    for name in sd:
        if not name.endswith(".qweight"):
            continue
        base = name[:-len(".qweight")]
        if base + ".scales" not in sd or base + ".qzeros" not in sd:
            raise ValueError(f"{base}: qweight without scales / qzeros")

        def unpack(base=base):
            q, z, s = (sd[base + k] for k in (".qweight", ".qzeros",
                                              ".scales"))
            if cfg.fmt == "awq":
                return unpack_awq_gemm(q, z, s, cfg.group_size)
            return unpack_gptq(q, z, s, cfg.group_size, v2=cfg.gptq_v2)
        computed[base + ".weight"] = unpack
        done.update((name, base + ".qzeros", base + ".scales",
                     base + ".g_idx"))
    return RenamedStateDict(sd, {n: n for n in sd if n not in done and
                                 n not in computed}, computed)
