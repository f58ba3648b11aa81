"""Linear layer methods: the quantization-algorithm dispatch.

Port of ``tensorrt_llm_tpu/ops/linear.py``: the unquantized method, the
weight-only ones (per-channel W8A16 / W4A16, group-wise W4A16_AWQ /
W4A16_GPTQ, NVFP4 / MXFP4), FP8 (per-tensor and 128 x 128 block scales)
and the int8 products (SmoothQuant W8A8, W4A8). Each method owns
``quantize_weights`` (load time: one float [K, N] weight to its stored
form), ``apply``, ``dequantize`` and ``fuse``.

Layouts. The unquantized method keeps PyTorch's [out, in] weight, so its
``apply`` is ``F.linear`` (a bf16 product accumulates in float32 inside
cuBLAS, as the JAX version asks with ``preferred_element_type``). Every
quantized method stores [K, N] = [in, out] integers, as the JAX package
does, so parameters carried across are the same bytes. A method never
guesses the layout from a shape: it is fixed by the method's class.

Routes of the group-wise methods, chosen by shape (never by catching an
error): a symmetric weight whose shape the kernel takes
(``ops.cuda.quant_matmul.kernel_takes``: M <= 128, group 16/32/64/128,
K a multiple of the group — of two groups for int4) goes through the
dequant-matmul kernel; more rows, a weight with zero points or any other
shape is dequantized to the activation's type and multiplied by a plain
matmul, where the JAX package dequantizes and leaves the dot to XLA.

The FP8 methods keep their e4m3 weight in device memory and, on a CUDA
device, multiply it through the e4m3 body of the same kernel
(``e4m3_dequant_matmul``) at up to 128 rows: one byte a weight is read,
none is widened in memory. Elsewhere (the CPU, more rows, a K that is
not a multiple of 128, and FP8 block under a float32 model, whose JAX
arithmetic keeps x in float32) they compute in the JAX package's order.
SmoothQuant and W4A8 quantize x per token to int8 and take one int8 x
int8 -> int32 product (``torch._int_mm``, where the JAX package calls
``lax.dot_general``; no kernel of this repository).
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..quantization.mode import QuantAlgo
from . import quant as Q
from .cuda.quant_matmul import (e4m3_dequant_matmul, e4m3_kernel_takes,
                                groupwise_dequant_matmul, kernel_takes)

Params = Dict[str, torch.Tensor]


class LinearMethod:
    """Unquantized matmul, weight [out, in]."""
    name = "unquantized"

    def quantize_weights(self, w: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16) -> Params:
        """w: [K, N] = [in, out] float, as for every method."""
        return {"weight": w.t().to(dtype).contiguous()}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, params["weight"], params.get("bias"))

    def dequantize(self, params: Params, dtype: torch.dtype) -> torch.Tensor:
        """The projection's weight as [K, N] = [in, out] floats of
        ``dtype`` (a view for this method)."""
        return params["weight"].t().to(dtype)

    def fuse(self, parts: List[Params]) -> Params:
        """Parameters of projections that share an input, joined along
        the output axis into one projection."""
        return fuse_params(parts, weight_dim=0)

    def same_as(self, other: "LinearMethod") -> bool:
        """Whether two projections can be fused under this method."""
        return type(other) is type(self) and vars(other) == vars(self)


class _QuantizedMethod(LinearMethod):
    """Shared by the weight-only methods: weight [K, N], every tensor
    indexed by output column on its last axis."""

    def fuse(self, parts: List[Params]) -> Params:
        return fuse_params(parts, weight_dim=-1)

    @staticmethod
    def _finish(out: torch.Tensor, params: Params, x: torch.Tensor
                ) -> torch.Tensor:
        out = out.reshape(*x.shape[:-1], out.shape[-1])
        if "bias" in params:
            out = out + params["bias"]
        return out


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` (w [out, in]) accumulated and returned in float32, as
    the JAX package's ``jnp.dot(..., preferred_element_type=float32)``
    (the EAGLE head's products, the MoE router and shared-expert gate)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return F.linear(x, w)
    if x.is_cuda:
        return torch.mm(x, w.t(), out_dtype=torch.float32)
    return F.linear(x.float(), w.float())


FP8_BLOCK = 128      # FP8 block scales: 128 x 128 tiles


def can_fuse(parts: List[Params]) -> bool:
    """Whether projections' parameters join along the output axis into
    one projection that computes the same columns: one set of tensors, no
    smoothing vector (each projection divides x by its own), and FP8
    block scales only where every part's columns fill whole blocks."""
    keys = set(parts[0])
    if any(set(p) != keys for p in parts) or "smooth" in keys:
        return False
    w, s = parts[0]["weight"], parts[0].get("weight_scale")
    if w.dtype == torch.float8_e4m3fn and s is not None and s.dim() == 2:
        return all(p["weight"].shape[-1] == p["weight_scale"].shape[-1]
                   * FP8_BLOCK for p in parts)
    return True


def fuse_params(parts: List[Params], weight_dim: int) -> Params:
    """Join projections along the output axis: ``weight_dim`` of the
    weight, the last axis of every other tensor. A per-tensor scale
    (0-dim) is expanded over its part's columns first, so each column
    keeps its own projection's scale."""
    if not can_fuse(parts):
        raise ValueError("cannot fuse projections with these parameter "
                         f"sets: {[sorted(p) for p in parts]}")

    def cols(p, k):
        v = p[k]
        if k == "weight_scale" and v.dim() == 0:
            return v.expand(p["weight"].shape[weight_dim])
        return v
    return {k: torch.cat([cols(p, k) for p in parts],
                         dim=weight_dim if k == "weight" else -1).contiguous()
            for k in parts[0]}


class WeightOnlyPerChannelMethod(_QuantizedMethod):
    """W8A16 / W4A16: one scale per output channel; dequantize, then a
    plain matmul. 4-bit values stay in int8 storage (range [-8, 7])."""

    def __init__(self, bits: int):
        self.bits = bits
        self.name = f"w{bits}a16"

    def quantize_weights(self, w, dtype=torch.bfloat16):
        q, s = Q.quantize_weight_per_channel(w, bits=self.bits)
        return {"weight": q, "weight_scale": s}

    def dequantize(self, params, dtype):
        return Q.dequantize_weight(params["weight"], params["weight_scale"],
                                   dtype=dtype)

    def apply(self, params, x):
        x2d = x.reshape(-1, x.shape[-1])
        return self._finish(torch.matmul(x2d, self.dequantize(params,
                                                              x.dtype)),
                            params, x)


class _GroupwiseMethod(_QuantizedMethod):
    """Group-scaled integer weights. ``packed``: symmetric int4, two per
    byte ([K/2, N])."""
    bits: int
    group_size: int

    def _packed(self, params: Params) -> bool:
        return self.bits == 4 and "weight_zero" not in params

    def dequantize(self, params, dtype):
        wq = params["weight"]
        if self._packed(params):
            wq = Q.unpack_int4(wq)
        return Q.dequantize_weight(wq, params["weight_scale"],
                                   zeros=params.get("weight_zero"),
                                   group_size=self.group_size, dtype=dtype)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x2d = x.reshape(-1, x.shape[-1])
        M, K = x2d.shape
        kernel_bits = 4 if self._packed(params) else 8
        if "weight_zero" not in params and \
                kernel_takes(M, K, self.group_size, kernel_bits):
            out = groupwise_dequant_matmul(
                x2d, params["weight"], params["weight_scale"],
                group_size=self.group_size, bits=kernel_bits)
        else:
            out = torch.matmul(x2d, self.dequantize(params, x.dtype))
        return self._finish(out, params, x)


class WeightOnlyGroupwiseMethod(_GroupwiseMethod):
    """W4A16_AWQ (symmetric, packed, through the kernel) / W4A16_GPTQ
    (asymmetric: zero points, dequantize-then-matmul)."""

    def __init__(self, group_size: int = 128, bits: int = 4,
                 asymmetric: bool = False):
        self.bits = bits
        self.asymmetric = asymmetric
        self.group_size = group_size
        self.name = f"w{bits}a16_group"

    def quantize_weights(self, w, dtype=torch.bfloat16):
        q, s, z = Q.quantize_weight_groupwise(
            w, group_size=self.group_size, bits=self.bits,
            asymmetric=self.asymmetric)
        if self.bits == 4 and z is None:
            q = Q.pack_int4(q)
        out = {"weight": q, "weight_scale": s}
        if z is not None:
            out["weight_zero"] = z
        return out


class Fp4GroupwiseMethod(_GroupwiseMethod):
    """NVFP4 (groups of 16, e4m3 group scales under a global float32
    scale) / MXFP4 (groups of 32, power-of-two scales). Weights round to
    the exact e2m1 grid at load and are stored as int8 holding twice the
    value with half-step group scales, so the int8 body of the
    dequant-matmul kernel computes the fp4 product; on the card both
    group sizes run it."""
    bits = 8

    def __init__(self, flavor: str = "nvfp4"):
        self.flavor = flavor
        self.group_size = 16 if flavor == "nvfp4" else 32
        self.name = flavor

    def quantize_weights(self, w, dtype=torch.bfloat16):
        q, s_half = Q.quantize_weight_fp4(
            w, group_size=self.group_size,
            scale_fmt="e4m3" if self.flavor == "nvfp4" else "e8m0")
        return {"weight": q, "weight_scale": s_half}


class Fp8QdqMethod(_QuantizedMethod):
    """FP8 e4m3 weights with one float32 scale per tensor (the JAX
    package's ``Fp8QdqMethod``, which serves FP8 and, with the same
    per-tensor scale, FP8_PER_CHANNEL_PER_TOKEN). ``apply`` rounds x to
    bf16 whatever the model's type, accumulates in float32, multiplies by
    the scale and returns x's type, as the JAX method does. A fused
    projection (q|k|v, gate|up) holds each part's scale over its own
    columns ([N]), so its columns are those of the parts."""
    name = "fp8"

    def quantize_weights(self, w, dtype=torch.bfloat16):
        q, s = Q.quantize_weight_fp8(w)
        return {"weight": q, "weight_scale": s}

    def dequantize(self, params, dtype):
        return (params["weight"].float() * params["weight_scale"]).to(dtype)

    def apply(self, params, x):
        x2d = x.reshape(-1, x.shape[-1])
        w, s = params["weight"], params["weight_scale"]
        if x.is_cuda and e4m3_kernel_takes(*x2d.shape):
            out = e4m3_dequant_matmul(x2d, w, s)
        else:
            out = (dot_f32(x2d.to(torch.bfloat16), w.to(torch.bfloat16).t())
                   * s).to(x.dtype)
        return self._finish(out, params, x)


class Fp8BlockwiseMethod(_QuantizedMethod):
    """FP8 e4m3 weights with one float32 scale per 128 x 128 block (the
    DeepSeek recipe; the JAX ``Fp8BlockwiseMethod``). The JAX ``apply``
    forms w = q * s in float32, casts it to x's type and multiplies;
    a bf16 x on a CUDA device takes the e4m3 body instead, which scales
    each group's float32 partial sum (the kernel's tolerance, not the JAX
    rounding of w to bf16)."""
    name = "fp8_block"

    def quantize_weights(self, w, dtype=torch.bfloat16):
        q, s = Q.quantize_weight_fp8_blockwise(w, block=FP8_BLOCK)
        return {"weight": q, "weight_scale": s}

    def dequantize(self, params, dtype):
        return Q.dequantize_fp8_blockwise(params["weight"],
                                          params["weight_scale"],
                                          FP8_BLOCK).to(dtype)

    def apply(self, params, x):
        x2d = x.reshape(-1, x.shape[-1])
        if x.is_cuda and x.dtype == torch.bfloat16 and \
                e4m3_kernel_takes(*x2d.shape):
            out = e4m3_dequant_matmul(x2d, params["weight"],
                                      params["weight_scale"])
        else:
            out = dot_f32(x2d, self.dequantize(params, x.dtype).t()
                          ).to(x.dtype)
        return self._finish(out, params, x)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N] (``torch._int_mm``). On
    CUDA the product takes more than 16 rows: fewer are padded with zero
    rows inside the call (a decode step's rows stay in its graph); K and
    N must be multiples of 8 there."""
    if a.is_cuda:
        M, K = a.shape
        if K % 8 or b.shape[1] % 8:
            raise ValueError(f"the int8 product takes K and N that are "
                             f"multiples of 8 on CUDA, got K={K} "
                             f"N={b.shape[1]}")
        rows = max(32, -(-M // 16) * 16)
        if rows != M:
            return torch._int_mm(F.pad(a, (0, 0, 0, rows - M)), b)[:M]
    return torch._int_mm(a, b)


class _Int8ProductMethod(_QuantizedMethod):
    """SmoothQuant and W4A8: int8 weights [K, N] and one float32 scale per
    output column (``_SCALE``); x divided by ``smooth`` (float32) when the
    projection holds one, quantized per token to int8, one int8 x int8 ->
    int32 product, then acc * x_scale * column scale in float32, in that
    order, in x's type."""
    _SCALE: str

    def dequantize(self, params, dtype):
        w = params["weight"].float() * params[self._SCALE]
        if "smooth" in params:
            w = w / params["smooth"][:, None]
        return w.to(dtype)

    def apply(self, params, x):
        x2d = x.reshape(-1, x.shape[-1])
        if "smooth" in params:
            x2d = (x2d.float() / params["smooth"]).to(x.dtype)
        xq, x_scale = Q.quantize_activation_per_token_int8(x2d)
        acc = int8_mm(xq, params["weight"])
        out = acc.float() * x_scale * params[self._SCALE]
        return self._finish(out.to(x.dtype), params, x)


class SmoothQuantMethod(_Int8ProductMethod):
    """W8A8: per-channel int8 weights, per-token int8 activations (the JAX
    ``SmoothQuantMethod``). With smoothing (``quantize_linear``'s
    ``smooth``) the weight's input rows were multiplied by s at load."""
    name = "w8a8_sq"
    _SCALE = "weight_scale"

    def quantize_weights(self, w, dtype=torch.bfloat16):
        q, s = Q.quantize_weight_per_channel(w, bits=8)
        return {"weight": q, "weight_scale": s}


class W4A8QServeMethod(_Int8ProductMethod):
    """W4A8 (the JAX ``W4A8QServeMethod``): int4-grid weights under
    per-group scales on the int8 grid and per-channel scales. The JAX
    ``apply`` rescales the int4 values to the int8 grid per group on
    every call; this port folds that rescale into the stored weight at
    load (``ops.quant.fold_w4a8``): the same int8 values, one per byte as
    the JAX package stores its int4 ones, kept with ``channel_scale``."""
    name = "w4a8"
    _SCALE = "channel_scale"

    def __init__(self, group_size: int = 128):
        self.group_size = group_size

    def quantize_weights(self, w, dtype=torch.bfloat16):
        G = self.group_size
        K, N = w.shape
        wg = w.float().reshape(max(1, K // max(1, G)), -1, N)
        ch_scale = Q.div(wg.abs().amax(dim=(0, 1)), 127.0) + 1e-12
        w8 = wg / ch_scale
        g_scale = Q.div(w8.abs().amax(dim=1, keepdim=True), 7.0) + 1e-12
        q = torch.round(w8 / g_scale).clamp(-8, 7).to(torch.int8)
        return {"weight": Q.fold_w4a8(q.reshape(K, N), g_scale[:, 0, :]),
                "channel_scale": ch_scale}


_NOT_PORTED = {
    QuantAlgo.W8A8_SQ_PER_TENSOR_PLUGIN: "SmoothQuant per-tensor",
    QuantAlgo.MIXED_PRECISION: "mixed precision",
}


def check_ported(algo: QuantAlgo) -> None:
    """Refuse, by name, a weight algorithm this package does not have."""
    if algo in _NOT_PORTED:
        raise NotImplementedError(
            f"quant_algo {algo.value} ({_NOT_PORTED[algo]}) is not "
            "supported by this package yet")


def make_linear_method(quant_config, layer_name: str = "") -> LinearMethod:
    """The method of one projection under ``quant_config`` (anything with
    ``quant_algo``, ``group_size`` and ``exclude_modules``; None means
    unquantized). A projection whose name contains an ``exclude_modules``
    entry stays unquantized."""
    if quant_config is None or quant_config.quant_algo == QuantAlgo.NO_QUANT:
        return LinearMethod()
    for pattern in quant_config.exclude_modules:
        if pattern and pattern in layer_name:
            return LinearMethod()
    algo = quant_config.quant_algo
    check_ported(algo)
    if algo == QuantAlgo.W8A16:
        return WeightOnlyPerChannelMethod(bits=8)
    if algo == QuantAlgo.W4A16:
        return WeightOnlyPerChannelMethod(bits=4)
    if algo == QuantAlgo.W4A16_AWQ:
        return WeightOnlyGroupwiseMethod(quant_config.group_size, bits=4,
                                         asymmetric=False)
    if algo == QuantAlgo.W4A16_GPTQ:
        return WeightOnlyGroupwiseMethod(quant_config.group_size, bits=4,
                                         asymmetric=True)
    if algo == QuantAlgo.NVFP4:
        return Fp4GroupwiseMethod(flavor="nvfp4")
    if algo == QuantAlgo.MXFP4:
        return Fp4GroupwiseMethod(flavor="mxfp4")
    if algo == QuantAlgo.W4A8_AWQ:
        return W4A8QServeMethod(quant_config.group_size)
    if algo in (QuantAlgo.W8A8_SQ_PER_CHANNEL,
                QuantAlgo.W8A8_SQ_PER_CHANNEL_PER_TOKEN_PLUGIN):
        return SmoothQuantMethod()
    if algo in (QuantAlgo.FP8, QuantAlgo.FP8_PER_CHANNEL_PER_TOKEN):
        return Fp8QdqMethod()
    if algo == QuantAlgo.FP8_BLOCK_SCALES:
        return Fp8BlockwiseMethod()
    raise NotImplementedError(f"quant algo {algo} not yet supported")
