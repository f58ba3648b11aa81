"""MXFP4 (microscaling fp4) checkpoint ingestion.

Port of ``tensorrt_llm_tpu/quantization/mxfp4.py`` (a copy: the port
imports nothing of the JAX package). GPT-OSS releases its experts as
``*_blocks`` (uint8, two e2m1 values a byte, low nibble first) and
``*_scales`` (uint8 e8m0 exponents, one per 32 values, value
``2^(s - 127)``). As in the JAX package they are dequantized on the host
at load, through the 16-entry e2m1 table times the block's power of two,
and the experts are then served in the model's type (bf16 on the card).

Layouts (OpenAI GPT-OSS checkpoints):
  blocks  u8[..., n_blocks, 16]   two fp4 values per byte, low nibble
                                  first (element order within block)
  scales  u8[..., n_blocks]       e8m0 exponent, value = 2^(s - 127)
"""
from __future__ import annotations

import numpy as np

# e2m1 magnitudes: [sign(1) | exp(2) | mantissa(1)]
_E2M1 = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0], np.float32)
_LUT = np.concatenate([_E2M1, -_E2M1])     # indexed by the 4-bit code


def _np(a) -> np.ndarray:
    """A numpy array of ``a`` (a numpy array, or a CPU torch tensor)."""
    return a.numpy() if hasattr(a, "numpy") else np.asarray(a)


def dequant_mxfp4(blocks, scales) -> np.ndarray:
    """u8 blocks [..., B, 16] + e8m0 scales [..., B] -> f32 [..., B*32]."""
    blocks = _np(blocks).astype(np.uint8, copy=False)
    scales = _np(scales).astype(np.uint8, copy=False)
    lo = _LUT[blocks & 0xF]                      # [..., B, 16]
    hi = _LUT[blocks >> 4]
    vals = np.stack([lo, hi], axis=-1).reshape(*blocks.shape[:-1], 32)
    scale = np.exp2(scales.astype(np.int32) - 127).astype(np.float32)
    out = vals * scale[..., None]
    return out.reshape(*blocks.shape[:-2], blocks.shape[-2] * 32)


def quantize_mxfp4(w) -> tuple:
    """f32 [..., K] -> (blocks u8[..., K/32, 16], scales u8[..., K/32]):
    the shared e8m0 scale is 2^ceil(log2(absmax / 6)), each value rounds
    to the nearest e2m1 magnitude (the tests' and conversion tools'
    encoder)."""
    w = _np(w)
    K = w.shape[-1]
    if K % 32:
        raise ValueError("MXFP4 needs the reduction dim % 32 == 0")
    v = np.asarray(w, np.float32).reshape(*w.shape[:-1], K // 32, 32)
    amax = np.abs(v).max(axis=-1)
    exp = np.where(amax > 0,
                   np.ceil(np.log2(np.maximum(amax, 1e-30) / 6.0)),
                   0.0).astype(np.int32)
    exp = np.clip(exp + 127, 0, 255).astype(np.uint8)
    scale = np.exp2(exp.astype(np.int32) - 127).astype(np.float32)
    scaled = v / scale[..., None]
    # the nearest e2m1 magnitude's code, the sign in bit 3
    idx = np.abs(np.abs(scaled)[..., None] - _E2M1).argmin(
        axis=-1).astype(np.uint8)
    idx = np.where(scaled < 0, idx + 8, idx).astype(np.uint8)
    blocks = (idx[..., 0::2] | (idx[..., 1::2] << 4)).astype(np.uint8)
    return blocks, exp


def normalize_mxfp4_state_dict(sd):
    """A view of ``sd`` in which every ``<name>_blocks`` /
    ``<name>_scales`` pair is replaced by the dequantized ``<name>``
    (float32, the checkpoint's [out, in] orientation kept; callers
    transpose as usual), dequantized when it is looked up. Other tensors
    pass through untouched."""
    from .lazy_state_dict import RenamedStateDict
    computed, done = {}, set()
    for key in sd:
        if not key.endswith("_blocks"):
            continue
        base = key[: -len("_blocks")]
        skey = base + "_scales"
        if skey not in sd:
            continue
        computed[base] = (lambda k=key, s=skey:
                          dequant_mxfp4(sd[k], sd[s]))
        done.update((key, skey))
    return RenamedStateDict(sd, {k: k for k in sd if k not in done},
                            computed)
