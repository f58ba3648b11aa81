"""Group-wise dequantize + matmul for weight-only quantized linears.

Replaces the TPU kernel ``groupwise_dequant_matmul``
(tensorrt_llm_tpu/ops/pallas/quant_matmul.py:105). The CUDA kernel is
``csrc/quant_matmul.cu``: a CTA per 32 output columns and up to 64 rows
walks K in chunks of 128 stored weight rows, staged with x and the scale
rows in a shared-memory ring by ``cp.async``; its warps widen the
int4/int8 values to bf16 and run ``mma.sync`` into float32 partial sums
that are scaled per group. At M <= 128 it is bound by the bytes of
the quantized weight (K*N/2 or K*N over the HBM bandwidth).

Arithmetic, as in the TPU kernel: x is rounded to bf16 whatever its type,
the integers widen to bf16 exactly, each group's partial product is
accumulated in float32 and multiplied by that group's float32 scale row,
and the sum over groups is returned in bf16 — for a float32 x too, as the
TPU kernel does (it takes its output type from x after the cast,
quant_matmul.py:131 and :156), so a float32 model carries bf16 from a
quantized projection into whatever follows, in both packages.

Dispatch, by shape only:
  * ``M > M_KERNEL_MAX`` (prefill): dequantize the weight to x's type and
    call one plain matmul (result in x's type), on any device — where the
    JAX package leaves the product to XLA;
  * otherwise a CUDA tensor launches the kernel (``LAUNCHES`` counts) or
    raises when the shape is outside ``kernel_takes``; a CPU tensor runs
    ``groupwise_dequant_matmul_plain``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..quant import dequantize_weight, unpack_int4
from . import _build

LAUNCHES = 0

M_KERNEL_MAX = 128
GROUP_SIZES = (16, 32, 64, 128)


def kernel_takes(M: int, K: int, group_size: int, bits: int) -> bool:
    """Whether the kernel's contract covers this product (any N)."""
    if M > M_KERNEL_MAX or group_size not in GROUP_SIZES:
        return False
    if bits == 4:
        return K % (2 * group_size) == 0
    return bits == 8 and K % group_size == 0


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built C entry point, with its ctypes signature set once."""
    fn = _build.load("quant_matmul").groupwise_dequant_matmul
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P_] * 4 + [I_] * 5 + [P_]
    fn.restype = I_
    return fn


def _check_shapes(x, w, scales, group_size: int, bits: int):
    M, K = x.shape
    N = w.shape[1]
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if w.dtype != torch.int8:
        raise TypeError(f"weights must be int8 storage, got {w.dtype}")
    if w.shape[0] * (2 if bits == 4 else 1) != K:
        raise ValueError(f"weight rows {w.shape[0]} do not match K={K} "
                         f"at {bits} bits")
    if K % group_size or tuple(scales.shape) != (K // group_size, N):
        raise ValueError(f"scales {tuple(scales.shape)} do not match "
                         f"K={K}, N={N}, group_size={group_size}")
    return M, K, N


def groupwise_dequant_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                                   scales: torch.Tensor, *,
                                   group_size: int = 128,
                                   bits: int = 4) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its arithmetic: bf16 x,
    integers widened exactly, one float32 partial product per group times
    that group's scales, summed, rounded to bf16."""
    M, K, N = _check_shapes(x, w, scales, group_size, bits)
    wq = unpack_int4(w) if bits == 4 else w
    ng = K // group_size
    xg = x.to(torch.bfloat16).float().reshape(M, ng, group_size)
    wg = wq.float().reshape(ng, group_size, N)
    part = torch.einsum("mgk,gkn->gmn", xg, wg)
    out = (part * scales.float()[:, None, :]).sum(dim=0)
    return out.to(torch.bfloat16)


def groupwise_dequant_matmul(x: torch.Tensor,        # [M, K]
                             w: torch.Tensor,        # int4: [K//2, N] packed
                                                     # int8: [K, N]
                             scales: torch.Tensor,   # [K//group_size, N] f32
                             *, group_size: int = 128,
                             bits: int = 4) -> torch.Tensor:
    """x @ dequant(w) -> [M, N], bf16 for M <= 128, else x's type."""
    global LAUNCHES
    M, K, N = _check_shapes(x, w, scales, group_size, bits)
    if M > M_KERNEL_MAX:
        wq = unpack_int4(w) if bits == 4 else w
        wd = dequantize_weight(wq, scales, group_size=group_size,
                               dtype=x.dtype)
        return torch.matmul(x, wd)
    if x.device.type == "cpu":
        return groupwise_dequant_matmul_plain(x, w, scales,
                                              group_size=group_size,
                                              bits=bits)
    if x.device.type != "cuda" or w.device != x.device or \
            scales.device != x.device:
        raise ValueError("x, w and scales must be on the same CUDA device")
    if not kernel_takes(M, K, group_size, bits):
        raise ValueError(
            f"shape outside the kernel's contract: M={M} K={K} "
            f"group_size={group_size} bits={bits}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported activation dtype {x.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {scales.dtype}")
    if not (w.is_contiguous() and scales.is_contiguous()):
        raise ValueError("w and scales must be contiguous")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    if w.data_ptr() % 4:
        raise ValueError("w must be 4-byte aligned")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    err = _kernel()(xb.data_ptr(), w.data_ptr(), scales.data_ptr(),
                    out.data_ptr(), M, K, N, group_size, bits,
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "groupwise_dequant_matmul")
    LAUNCHES += 1
    return out
