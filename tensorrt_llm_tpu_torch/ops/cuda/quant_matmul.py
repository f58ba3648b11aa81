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
    fn.argtypes = [P_] * 4 + [I_] * 6 + [P_]
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
                    out.data_ptr(), M, K, N, group_size, bits, splits,
                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "groupwise_dequant_matmul")
    _build.count_launch(__name__)
    return out
