"""Weight quantize / dequantize primitives.

Port of the weight side of ``tensorrt_llm_tpu/ops/quant.py`` and of
``pack_int4`` / ``unpack_int4`` from
``tensorrt_llm_tpu/ops/pallas/quant_matmul.py``. Plain functions on
tensors; every result lives on the device of its input. Integer outputs
are bit-identical to the JAX functions' on the same input (both round
half to even).

Conventions (quantized weights are stored [in_features, out_features] =
[K, N], unlike unquantized ones, which keep PyTorch's [out, in]):
  * per-channel: scales[N], symmetric;
  * group-wise (AWQ/GPTQ, group size G along K): scales[K//G, N] and
    optional zero points of the same shape;
  * int4 values live in int8 storage, range [-8, 7]; ``pack_int4`` puts
    two in a byte for the footprint;
  * fp4 (e2m1) values are stored as int8 holding twice the value, with
    group scales of half the nominal step, so the int8 group-wise
    dequantization reproduces the exact fp4 number;
  * fp8 (e4m3) weights: one float32 scale per tensor, or one per
    128 x 128 block ([ceil(K/128), ceil(N/128)]); the bytes equal the JAX
    package's (both divide in float32 and round to nearest even).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

INT8_MAX = 127.0
INT4_MAX = 7.0
FP8_MAX = 448.0  # e4m3 finite max

_E2M1_GRID = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)


def div(a: torch.Tensor, d: float) -> torch.Tensor:
    """a / d rounded as a true division on every device. CUDA multiplies
    by the reciprocal of a host-number divisor, which can differ from the
    quotient in the last bit (and so move a scale, and the integers and
    fp8 bytes it makes); dividing by a tensor of d's divides. Made by a
    fill on a's device, so a CUDA graph can capture it."""
    return a / torch.full_like(a, d)


# --------------------------------------------------------------------- #
# Weight quantization (load time)
# --------------------------------------------------------------------- #
def quantize_weight_per_channel(w: torch.Tensor, bits: int = 8
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel quantization. w: [K, N] float ->
    (q int8[K, N], scale f32[N]); 4-bit values stay in int8 storage."""
    qmax = INT8_MAX if bits == 8 else INT4_MAX
    wf = w.float()
    scale = div(wf.abs().amax(dim=0), qmax).clamp(min=1e-8)
    q = torch.round(wf / scale).clamp(-qmax - 1, qmax)
    return q.to(torch.int8), scale


def quantize_weight_groupwise(w: torch.Tensor, group_size: int = 128,
                              bits: int = 4, asymmetric: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         Optional[torch.Tensor]]:
    """AWQ/GPTQ-style group quantization along K. Returns (q int8[K, N],
    scales f32[K//G, N], zeros f32[K//G, N] or None)."""
    K, N = w.shape
    if K % group_size:
        raise ValueError(f"K={K} not divisible by group_size={group_size}")
    g = w.float().reshape(K // group_size, group_size, N)
    qmax = INT4_MAX if bits == 4 else INT8_MAX
    if asymmetric:
        lo = g.amin(dim=1, keepdim=True)
        hi = g.amax(dim=1, keepdim=True)
        scale = div(hi - lo, 2 * qmax + 1).clamp(min=1e-8)
        zero = torch.round(-lo / scale) - (qmax + 1)
        q = (torch.round(g / scale) + zero).clamp(-qmax - 1, qmax)
        zeros = zero[:, 0, :].contiguous()
    else:
        scale = div(g.abs().amax(dim=1, keepdim=True), qmax).clamp(min=1e-8)
        q = torch.round(g / scale).clamp(-qmax - 1, qmax)
        zeros = None
    return (q.reshape(K, N).to(torch.int8), scale[:, 0, :].contiguous(),
            zeros)


def dequantize_weight(q: torch.Tensor, scales: torch.Tensor,
                      zeros: Optional[torch.Tensor] = None,
                      group_size: Optional[int] = None,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Inverse of the quantizers above: (q - zero) * scale in float32,
    cast to ``dtype``. q: int8[K, N] (unpacked)."""
    K, N = q.shape
    qf = q.float()
    if scales.dim() == 1:                         # per-channel
        out = qf * scales[None, :]
    else:                                         # group-wise
        G = group_size or K // scales.shape[0]
        qg = qf.reshape(K // G, G, N)
        if zeros is not None:
            qg = qg - zeros[:, None, :]
        out = (qg * scales[:, None, :]).reshape(K, N)
    return out.to(dtype)


# --------------------------------------------------------------------- #
# int4 packing (split halves)
# --------------------------------------------------------------------- #
def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 values [K, N] (int8 storage, range [-8, 7]) -> int8[K//2, N]:
    packed row i holds row i in the low nibble and row i + K//2 in the
    high nibble."""
    K = q.shape[0]
    if K % 2:
        raise ValueError(f"K={K} must be even to pack two rows per byte")
    lo = q[:K // 2].to(torch.int32) & 0x0F
    hi = q[K // 2:].to(torch.int32) & 0x0F
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4`` -> int8[K, N] in [-8, 7] (both nibbles
    sign-extended)."""
    p = packed.to(torch.int32)                    # sign-extended byte
    lo = ((p & 0x0F) ^ 8) - 8
    hi = p >> 4                                   # arithmetic shift
    return torch.cat([lo, hi], dim=0).to(torch.int8)


# --------------------------------------------------------------------- #
# FP4 (e2m1): NVFP4 / MXFP4
# --------------------------------------------------------------------- #
def fp4_round(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest e2m1 value (a tie goes to the larger
    magnitude), saturating at +-6. Elementwise against host constants
    only (no host-to-device copy), so a CUDA graph can capture it: the
    KV append of an NVFP4 cache runs inside the decode windows."""
    xf = x.float()
    a = xf.abs()
    mag = torch.zeros_like(a)
    for lo, hi in zip(_E2M1_GRID[:-1], _E2M1_GRID[1:]):
        mag = torch.where(a >= (lo + hi) / 2.0, hi, mag)   # up to the top
    return torch.where(xf < 0, -mag, mag)


def quantize_weight_fp4(w: torch.Tensor, group_size: int = 16,
                        scale_fmt: str = "e4m3"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NVFP4 (group 16, e4m3 group scales under one global float32 scale)
    or MXFP4 (group 32, power-of-two scales) quantization along K.
    Returns (q int8[K, N] holding 2 x the e2m1 value, half_scales
    f32[K//G, N] = group scale / 2), so that
    ``dequantize_weight(q, half_scales, group_size=G)`` is the fp4 value."""
    K, N = w.shape
    if K % group_size:
        raise ValueError(f"K={K} not divisible by fp4 group {group_size}")
    g = w.float().reshape(K // group_size, group_size, N)
    amax = g.abs().amax(dim=1)                                # [K/G, N]
    if scale_fmt == "e8m0":
        exp = torch.where(amax > 0,
                          torch.ceil(torch.log2(div(amax.clamp(min=1e-30), 6.0))),
                          torch.zeros_like(amax))
        scale = torch.exp2(exp)
    else:
        scale2 = div(amax.max(), 6.0 * 448.0).clamp(min=1e-30)
        s_rel = div(amax, 6.0) / scale2
        s_rel = s_rel.to(torch.float8_e4m3fn).float()
        scale = (s_rel * scale2).clamp(min=1e-30)
    codes = fp4_round(g / scale[:, None, :])
    q = (codes * 2.0).to(torch.int8).reshape(K, N)
    return q, scale / 2.0


# --------------------------------------------------------------------- #
# FP8 (e4m3) weights and per-token int8 activations
# --------------------------------------------------------------------- #
def quantize_weight_fp8(w: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor e4m3: (q e4m3 [K, N], scale f32 0-dim), w = q * scale."""
    wf = w.float()
    scale = div(wf.abs().amax(), FP8_MAX).clamp(min=1e-8)
    return (wf / scale).to(torch.float8_e4m3fn), scale


def quantize_weight_fp8_blockwise(w: torch.Tensor, block: int = 128
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-scaled e4m3 (one scale per ``block`` x ``block`` tile, the
    edge tiles padded with zeros): (q e4m3 [K, N], scales f32
    [ceil(K/block), ceil(N/block)])."""
    K, N = w.shape
    pk, pn = -K % block, -N % block
    wp = torch.nn.functional.pad(w.float(), (0, pn, 0, pk))
    Kp, Np = wp.shape
    blocks = wp.reshape(Kp // block, block, Np // block, block)
    absmax = blocks.abs().amax(dim=(1, 3), keepdim=True)
    scale = div(absmax, FP8_MAX).clamp(min=1e-8)
    q = (blocks / scale).to(torch.float8_e4m3fn).reshape(Kp, Np)[:K, :N]
    return q.contiguous(), scale[:, 0, :, 0].contiguous()


def dequantize_fp8_blockwise(q: torch.Tensor, scales: torch.Tensor,
                             block: int = 128) -> torch.Tensor:
    """q * its block's scale, float32 [K, N]."""
    K, N = q.shape
    s = scales.repeat_interleave(block, 0)[:K].repeat_interleave(
        block, 1)[:, :N]
    return q.float() * s


def quantize_activation_per_token_int8(x: torch.Tensor
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 per row of the last axis: (q int8, scale
    f32 [..., 1]), x ~ q * scale."""
    xf = x.float()
    scale = div(xf.abs().amax(dim=-1, keepdim=True), INT8_MAX).clamp(
        min=1e-8)
    q = torch.round(xf / scale).clamp(-128, 127)
    return q.to(torch.int8), scale


def fold_w4a8(q: torch.Tensor, group_scales: torch.Tensor) -> torch.Tensor:
    """W4A8's int4-grid values [K, N] rescaled to the int8 grid by their
    group scales [K/G, N]: clip(round(q * scale), -127, 127) as int8, the
    values the JAX ``W4A8QServeMethod.apply`` computes on every call."""
    K, N = q.shape
    Gk = group_scales.shape[0]
    w8 = q.float().reshape(Gk, -1, N) * group_scales.float()[:, None, :]
    return torch.round(w8).clamp(-127, 127).to(torch.int8).reshape(K, N)
