"""Linear layer methods: the quantization-algorithm dispatch.

Port of ``tensorrt_llm_tpu/ops/linear.py``: the unquantized method and
the weight-only ones (per-channel W8A16 / W4A16, group-wise W4A16_AWQ /
W4A16_GPTQ, NVFP4 / MXFP4). Each method owns ``quantize_weights`` (load
time: one float [K, N] weight to its stored form) and ``apply``.

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
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..quantization.mode import QuantAlgo
from . import quant as Q
from .cuda.quant_matmul import groupwise_dequant_matmul, kernel_takes

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


def fuse_params(parts: List[Params], weight_dim: int) -> Params:
    """Join projections along the output axis: ``weight_dim`` of the
    weight, the last axis of every other tensor."""
    keys = set(parts[0])
    if any(set(p) != keys for p in parts):
        raise ValueError("cannot fuse projections with different "
                         f"parameter sets: {[sorted(p) for p in parts]}")
    return {k: torch.cat([p[k] for p in parts],
                         dim=weight_dim if k == "weight" else -1).contiguous()
            for k in keys}


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


_NOT_PORTED = {
    QuantAlgo.W4A8_AWQ: "W4A8",
    QuantAlgo.W8A8_SQ_PER_CHANNEL: "SmoothQuant",
    QuantAlgo.W8A8_SQ_PER_TENSOR_PLUGIN: "SmoothQuant",
    QuantAlgo.W8A8_SQ_PER_CHANNEL_PER_TOKEN_PLUGIN: "SmoothQuant",
    QuantAlgo.FP8: "FP8 per-tensor",
    QuantAlgo.FP8_PER_CHANNEL_PER_TOKEN: "FP8 per-channel per-token",
    QuantAlgo.FP8_BLOCK_SCALES: "FP8 block scales",
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
    raise NotImplementedError(f"quant algo {algo} not yet supported")
