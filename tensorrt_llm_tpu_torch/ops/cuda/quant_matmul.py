"""Group-wise dequantize + matmul for weight-only quantized linears.

Replaces the TPU kernel ``groupwise_dequant_matmul``
(tensorrt_llm_tpu/ops/pallas/quant_matmul.py:105). The CUDA kernel is
``csrc/quant_matmul.cu``, designed for Hopper: it computes the product
transposed, so that the widened int4/int8 weights are ``wgmma``'s A
operand in registers and x is its B operand in shared memory; a CTA
covers 128 weight columns and up to 64 rows, K is split across the CTAs
of a thread-block cluster whose float32 partial tiles are summed in a
fixed order through distributed shared memory (one launch, no atomics,
the same bits on every call), and one producer warp keeps a ring of TMA
stages in flight behind mbarriers. Up to 64 rows it is bound by
the bytes of the quantized weight (K*N/2 or K*N over the HBM bandwidth);
at 128 rows by the tensor cores. The source's head says what the design
does about each cost of the first version.

The split count comes from ``choose_splits``, a pure function of host
ints (rows, K, N, group size, bits, SM count), so the grid is fixed for a
shape and a launch can be captured in a CUDA graph. ``split_chunks`` is
the share of K each CTA takes, as the kernel computes it.

Arithmetic, as in the TPU kernel: x is rounded to bf16 whatever its type,
the integers widen to bf16 exactly, each group's partial product is
accumulated in float32 and multiplied by that group's float32 scale row,
and the sum over groups is returned in bf16 — for a float32 x too, as the
TPU kernel does (it takes its output type from x after the cast,
quant_matmul.py:131 and :156), so a float32 model carries bf16 from a
quantized projection into whatever follows, in both packages.

The e4m3 body (``e4m3_dequant_matmul``): float8 e4m3 weights [K, N] of
the FP8 methods (ops/linear.py), group 128, with the scales as the
methods keep them: one for the tensor (0-dim), one per column for every
group ([N]: a fused per-tensor projection) or FP8 block scales
[K/128, ceil(N/128)]; the kernel reads each through a row stride and a
column shift, so nothing is expanded per call. Arithmetic: bf16 x, the
e4m3 values exact in bf16, a float32 partial product per group of 128
times its scale, summed; the result in x's type (bf16, or float32 for a
float32 x: the JAX FP8 methods return x's type), at up to 128 rows on
CUDA. ``LAUNCHES`` counts its launches with the integer bodies' and
``LAUNCHES_E4M3`` alone. The JAX
package has no kernel here: on the TPU it leaves the fp8 product to XLA.

Dispatch, by shape only:
  * ``M > M_KERNEL_MAX`` (prefill): dequantize the weight to x's type and
    call one plain matmul (result in x's type), on any device — where the
    JAX package leaves the product to XLA;
  * otherwise a CUDA tensor launches the kernel (``LAUNCHES`` counts it,
    a captured launch once per replay of its graph) or
    raises when the shape is outside ``kernel_takes``; a CPU tensor runs
    ``groupwise_dequant_matmul_plain``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from ..quant import dequantize_weight, unpack_int4
from . import _build

LAUNCHES = 0
LAUNCHES_E4M3 = 0

M_KERNEL_MAX = 128
GROUP_SIZES = (16, 32, 64, 128)
TILE_N = 128          # weight columns per CTA
ROW_BLOCK = 64        # x rows per CTA; more rows take a second row block
# CTAs of a cluster along K. 8 is the portable limit, but a CTA takes a
# whole SM (its shared-memory ring), and not every GPC has room for two
# clusters of eight at once: on an H100 the o shape ran 17.2 µs with 8
# and 12.4 µs with 4 (PERF.md).
MAX_SPLITS = 4


def kernel_takes(M: int, K: int, group_size: int, bits: int) -> bool:
    """Whether the kernel's contract covers this product (any N)."""
    if M > M_KERNEL_MAX or group_size not in GROUP_SIZES:
        return False
    if bits == 4:
        return K % (2 * group_size) == 0
    return bits == 8 and K % group_size == 0


def chunk_rows(group_size: int) -> int:
    """Stored weight rows per chunk: one group, or 64 rows of smaller
    groups. A chunk is the unit of the split along K."""
    return max(group_size, 64)


def num_chunks(K: int, group_size: int, bits: int) -> int:
    stored = K // 2 if bits == 4 else K
    return -(-stored // chunk_rows(group_size))


def choose_splits(M: int, K: int, N: int, group_size: int, bits: int,
                  sm_count: int) -> int:
    """How many CTAs share K for each output tile: a pure function of host
    ints. Aim for about one CTA per SM (tiles x splits <= SMs), never more
    splits than chunks or than ``MAX_SPLITS``; a power of two, so the
    cluster's CTAs divide the tile's float4s evenly and clusters pack into
    the card's GPCs."""
    tiles = -(-N // TILE_N) * -(-M // ROW_BLOCK)
    want = min(max(1, sm_count // tiles), MAX_SPLITS,
               num_chunks(K, group_size, bits))
    return 1 << (want.bit_length() - 1)


def split_chunks(chunks: int, splits: int) -> List[Tuple[int, int]]:
    """(first chunk, count) of each CTA along K: an even share, the first
    ``chunks % splits`` CTAs one more (the kernel computes the same)."""
    per, extra = divmod(chunks, splits)
    return [(r * per + min(r, extra), per + (1 if r < extra else 0))
            for r in range(splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built C entry point, with its ctypes signature set once."""
    fn = _build.load("quant_matmul").groupwise_dequant_matmul
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P_] * 4 + [I_] * 10 + [P_]
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
    splits = choose_splits(M, K, N, group_size, bits,
                           _sm_count(x.device.index or 0))
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    err = _kernel()(xb.data_ptr(), w.data_ptr(), scales.data_ptr(),
                    out.data_ptr(), M, K, N, group_size, bits, 0, splits,
                    N, 0, 0, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "groupwise_dequant_matmul")
    _build.count_launch(__name__)
    return out


# --------------------------------------------------------------------- #
# The e4m3 body
# --------------------------------------------------------------------- #
E4M3_GROUP = 128      # rows per scale group of the e4m3 body (FP8 block)


def e4m3_kernel_takes(M: int, K: int) -> bool:
    """Whether the e4m3 body's contract covers this product (any N)."""
    return M <= M_KERNEL_MAX and K % E4M3_GROUP == 0


def _scale_map(scales: torch.Tensor, K: int, N: int) -> Tuple[int, int]:
    """(row stride, column shift) of the kernel's scale read, by the
    scales' shape: 0-dim per-tensor, [N] per column, or block
    [K/128, ceil(N/128)]."""
    blocks = (K // E4M3_GROUP, -(-N // E4M3_GROUP))
    if scales.dim() == 0:
        return 0, 31
    if tuple(scales.shape) == (N,):
        return 0, 0
    if tuple(scales.shape) == blocks:
        return blocks[1], 7
    raise ValueError(f"e4m3 scales {tuple(scales.shape)} are none of (), "
                     f"({N},) and {blocks}")


def e4m3_group_scales(scales: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """The scales as float32 [K/128, N], one row per group of 128 rows."""
    row, shift = _scale_map(scales, K, N)
    cols = torch.arange(N, device=scales.device) >> shift
    flat = scales.float().reshape(-1)
    idx = torch.arange(K // E4M3_GROUP, device=scales.device)[:, None] * row
    return flat[idx + cols[None, :]]


def _check_e4m3(x, w, scales):
    M, K = x.shape
    if w.dtype != torch.float8_e4m3fn:
        raise TypeError(f"weights must be float8 e4m3, got {w.dtype}")
    if w.shape[0] != K or K % E4M3_GROUP:
        raise ValueError(f"weight {tuple(w.shape)} does not match K={K} "
                         f"(a multiple of {E4M3_GROUP})")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported activation dtype {x.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError(f"scales must be float32, got {scales.dtype}")
    _scale_map(scales, K, w.shape[1])
    return M, K, w.shape[1]


def e4m3_dequant_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                              scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the e4m3 body, with its arithmetic: bf16
    x, e4m3 values exact, one float32 partial product per group of 128
    times that group's scales, summed, in x's type."""
    M, K, N = _check_e4m3(x, w, scales)
    ng = K // E4M3_GROUP
    xg = x.to(torch.bfloat16).float().reshape(M, ng, E4M3_GROUP)
    wg = w.float().reshape(ng, E4M3_GROUP, N)
    part = torch.einsum("mgk,gkn->gmn", xg, wg)
    out = (part * e4m3_group_scales(scales, K, N)[:, None, :]).sum(dim=0)
    return out.to(x.dtype)


def e4m3_dequant_matmul(x: torch.Tensor,          # [M, K] bf16 / float32
                        w: torch.Tensor,          # [K, N] float8 e4m3
                        scales: torch.Tensor      # (), [N] or block
                        ) -> torch.Tensor:
    """x @ (w * scales) -> [M, N] in x's type: a CPU tensor runs
    ``e4m3_dequant_matmul_plain``; a CUDA tensor launches the e4m3 body,
    up to 128 rows (the FP8 methods take their own route above)."""
    M, K, N = _check_e4m3(x, w, scales)
    if x.device.type == "cpu":
        return e4m3_dequant_matmul_plain(x, w, scales)
    if x.device.type != "cuda" or w.device != x.device or \
            scales.device != x.device:
        raise ValueError("x, w and scales must be on the same CUDA device")
    if M > M_KERNEL_MAX:
        raise ValueError(f"shape outside the e4m3 body's contract: M={M}")
    if not (w.is_contiguous() and scales.is_contiguous()):
        raise ValueError("w and scales must be contiguous")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:
        xb = xb.clone()
    row, shift = _scale_map(scales, K, N)
    splits = choose_splits(M, K, N, E4M3_GROUP, 8,
                           _sm_count(x.device.index or 0))
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = _kernel()(xb.data_ptr(), w.data_ptr(), scales.data_ptr(),
                    out.data_ptr(), M, K, N, E4M3_GROUP, 8, 1, splits, row,
                    shift, int(x.dtype == torch.float32),
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "e4m3_dequant_matmul")
    _build.count_launch(__name__)
    _build.count_launch(__name__, "LAUNCHES_E4M3")
    return out
