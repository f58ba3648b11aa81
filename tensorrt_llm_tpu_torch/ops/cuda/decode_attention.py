"""Paged GQA decode attention (one query token per sequence).

Replaces the TPU kernel ``paged_decode_attention``
(tensorrt_llm_tpu/ops/pallas/decode_attention.py:164). The CUDA kernels
are in ``csrc/decode_attention.cu``. The function is bound by the KV bytes
it reads (bytes / HBM bandwidth), so the design is about keeping enough
bytes in flight whatever the batch: the KV axis is split across CTAs
(flash-decoding; ``choose_splits`` picks the count on the host from ints
it already has, so nothing syncs and the grid is fixed under a CUDA
graph), every warp streams its own tiles through its own cp.async ring,
and for bf16 the query heads of a KV head are one tensor-core tile
(mma.sync on bf16, float32 softmax). Each split leaves an unnormalised
partial (m, l, acc) in scratch allocated here, and a small merge kernel
combines them; one split writes the output directly. float32 inputs take
the first version's CUDA-core kernel (float32 math throughout, 1e-4
against the plain version), with the same splits. Head dims 48, 64, 80,
96, 128 and 256 (``HEAD_DIMS``; 80 and 96 are staged as 128-wide tiles and
48 as 64-wide ones, zero past the head dim, and read and written at their
own width; at 256 a warp's stage is 16 KB and Q waits in shared memory),
any other is refused by name; a KV head may carry any number of query
heads (16 per CTA). Left for later: TMA, one launch instead of two when
split, tiles of the head dim's own width at 48, 80 and 96.

8-bit pools (``KV_DTYPES``: int8 and float8 e4m3, the TPU kernel's
``k_scale`` / ``v_scale`` dequant): the pool may hold q's type or one of
these, dequantized by per-layer scales (0-dim float32 tensors on the
device, or floats). The plain versions dequantize as the JAX package does
(``dequant_kv``: ``k.float() * k_scale``, then q's type); the kernels copy
the 8-bit tiles and dequantize them in shared memory with the same
arithmetic (the same bf16 or float32 operands), then run as on a pool of
q's type. The scales stay device pointers, so a CUDA graph reads the value
current at each replay.

``paged_decode_attention`` launches the kernel for CUDA tensors and runs
``paged_decode_attention_plain`` only for CPU tensors.
``paged_decode_attention_plain(..., num_splits=n)`` is the plain PyTorch
version of the split algorithm: one partial per split, merged with the
kernel's formulas. ``LAUNCHES`` counts wrapper calls that launched (one
per call, whatever the number of splits; a captured call counts once per
replay of its graph, ``_build.count_launch``). Grids, split counts and
the scratch for the partials come from host ints and ``torch.empty``, so
a launch can be captured in a CUDA graph (the scratch then comes from
the graph's pool).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from . import _build

LAUNCHES = 0
# launches that carried attention sinks, and ALiBi slopes (counted with
# LAUNCHES, where the kernel launches)
LAUNCHES_SINKS = 0
LAUNCHES_ALIBI = 0
# launches on the sparse route's compacted page tables
# (ops/sparse_attention.py; counted with LAUNCHES, where the kernel
# launches)
LAUNCHES_SPARSE = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the quantized (8-bit) KV pool types, those of ModelConfig.kv_cache_dtype
# under INT8, FP8 and NVFP4, and their csrc AttnKv codes (0: the pool
# holds q's own type)
KV_DTYPES = {torch.int8: 1, torch.float8_e4m3fn: 2}
HEAD_DIMS = (48, 64, 80, 96, 128, 256)   # the head dims the kernels are built for


def _as_f32(x, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()


def dequant_kv(x: torch.Tensor, scale, dtype: torch.dtype) -> torch.Tensor:
    """Pool values in q's type: times the scale in float32 first when one
    is given (an 8-bit pool; the JAX package's ``k.astype(f32) *
    k_scale``, ops/attention.py:529-532), else cast."""
    if scale is not None:
        x = x.float() * scale
    return x.to(dtype)


def kv_code(q_dtype: torch.dtype, pool_dtype: torch.dtype) -> int:
    """csrc's AttnKv code of a pool next to queries of ``q_dtype``: 0 for
    q's own type, else an 8-bit type of ``KV_DTYPES``; anything else is
    refused by name."""
    if q_dtype not in _DTYPES:
        raise TypeError(f"unsupported query dtype {q_dtype}")
    if pool_dtype == q_dtype:
        return 0
    if pool_dtype in KV_DTYPES:
        return KV_DTYPES[pool_dtype]
    raise TypeError(f"unsupported KV pool dtype {pool_dtype} beside "
                    f"queries of {q_dtype}: the pool holds q's type, int8 "
                    "or float8_e4m3fn")


def scale_ptr(scale, device: torch.device) -> Optional[torch.Tensor]:
    """A dequant scale as a float32 scalar on ``device`` (the kernel reads
    it there), or None. A tensor already there passes as it is; a float
    becomes one by a fill (no host-to-device copy, so a capture takes
    it)."""
    if scale is None:
        return None
    if isinstance(scale, torch.Tensor):
        if scale.numel() != 1 or scale.device != device:
            raise ValueError("a KV scale is one float32 value on the "
                             "queries' device")
        return scale.reshape(()).to(torch.float32)
    return torch.full((), float(scale), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built C entry point, with its ctypes signature set once."""
    fn = _build.load("decode_attention").paged_decode_attention
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P_] * 9 + [I_] * 7 + [F_, I_, F_, I_, I_, I_, P_, P_, P_]
    fn.restype = I_
    return fn


SPLIT_TILE = 32        # positions per tile of the split rule (the bf16
                       # kernel's warp tile is 32 at hd 64, else 16)
MIN_SPLIT = 256        # no split is planned shorter than this
_MASK = -0.7 * torch.finfo(torch.float32).max   # csrc ATTN_MASK


def choose_splits(num_seqs: int, num_kv_heads: int, max_kv_len: int,
                  sm_count: int, group: int = 1) -> int:
    """How many ways to split the KV axis: a pure function of host ints.

    One split gives ``num_seqs * num_kv_heads`` CTAs (times the chunks of
    16 query heads per KV head). Aim for one CTA per SM (measured: once
    every SM has a CTA, more splits only add partials to write and merge),
    never plan a split shorter than ``MIN_SPLIT`` positions of the longest
    row, never more splits than tiles."""
    ctas = max(1, num_seqs * num_kv_heads * (-(-group // 16)))
    want = -(-sm_count // ctas)
    by_len = max(1, max_kv_len // MIN_SPLIT)
    tiles = max(1, -(-max_kv_len // SPLIT_TILE))
    return max(1, min(want, by_len, tiles))


def _split_bounds(kv_lens: torch.Tensor, window: Optional[int], tile: int,
                  splits: int, split: int):
    """[lo, hi) per row for one split: csrc attention_common.cuh
    split_range, vectorized over rows."""
    kv = kv_lens.long()
    start = (kv - window).clamp(min=0) if window else torch.zeros_like(kv)
    start = start // tile * tile
    tiles = (kv - start + tile - 1).clamp(min=0) // tile
    per = (tiles + splits - 1) // splits
    lo = start + torch.minimum(split * per, tiles) * tile
    hi = torch.minimum(kv, start + torch.minimum((split + 1) * per, tiles)
                       * tile)
    return lo, hi


def paged_decode_attention_plain(q: torch.Tensor, kv_pages: torch.Tensor,
                                 kv_lens: torch.Tensor,
                                 page_indices: torch.Tensor, *,
                                 sm_scale: float,
                                 sliding_window: Optional[int] = None,
                                 soft_cap: Optional[float] = None,
                                 alibi_slopes: Optional[Sequence[float]] = None,
                                 sinks: Optional[torch.Tensor] = None,
                                 num_splits: int = 1,
                                 k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather every page of the page
    table, dequantize an 8-bit pool (``dequant_kv``), mask positions past
    kv_len (and outside the window), softmax in float32 (with the sink
    logit in the denominator when given).

    With ``num_splits`` > 1 it runs the kernel's split algorithm: each
    split computes (m, l, acc) over its share of the row's visible range,
    seeded with ``_MASK`` (the sink logit only in split 0), and the merge
    weighs every partial by exp(m_i - max m)."""
    S, qh, hd = q.shape
    P, ps, combined, _ = kv_pages.shape
    kvh = combined // 2
    group = qh // kvh
    max_kv = page_indices.shape[1] * ps
    pages = kv_pages[page_indices.clamp(0, P - 1).reshape(-1).long()]
    pages = pages.reshape(S, max_kv, combined, hd)
    k = dequant_kv(pages[:, :, 0::2], k_scale, q.dtype).float()
    v = dequant_kv(pages[:, :, 1::2], v_scale, q.dtype).float()  # [S, kv, kvh, hd]
    qg = q.float().reshape(S, kvh, group, hd)
    scores = torch.einsum("skgd,sckd->skgc", qg, k) * sm_scale
    pos = torch.arange(max_kv, device=q.device)
    q_pos = kv_lens.long() - 1
    if alibi_slopes is not None:
        sl = _as_f32(alibi_slopes, q.device).reshape(kvh, group)
        dist = (pos[None, :] - q_pos[:, None]).float()
        scores = scores + sl[None, :, :, None] * dist[:, None, None, :]
    if soft_cap is not None:
        scores = soft_cap * torch.tanh(scores / soft_cap)
    valid = pos[None, :] < kv_lens.long()[:, None]
    if sliding_window is not None:
        valid &= pos[None, :] > q_pos[:, None] - sliding_window
    sk = None
    if sinks is not None:
        sk = _as_f32(sinks, q.device).reshape(1, kvh, group)
    if num_splits == 1:
        scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
        m = scores.amax(dim=-1)
        if sk is not None:
            m = torch.maximum(m, sk)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        e = torch.exp(scores - m[..., None])
        denom = e.sum(dim=-1)
        if sk is not None:
            denom = denom + torch.exp(sk - m)
        probs = e / denom.clamp(min=1e-30)[..., None]
        out = torch.einsum("skgc,sckd->skgd", probs, v)
        return out.reshape(S, qh, hd).to(q.dtype)

    parts = []
    for i in range(num_splits):
        lo, hi = _split_bounds(kv_lens, sliding_window, SPLIT_TILE,
                               num_splits, i)
        mine = valid & (pos[None, :] >= lo[:, None]) \
            & (pos[None, :] < hi[:, None])
        sc = scores.masked_fill(~mine[:, None, None, :], float("-inf"))
        m = sc.amax(dim=-1).clamp(min=_MASK)             # [S, kvh, g]
        l = torch.zeros_like(m)
        if sk is not None and i == 0:                    # the sink, once
            m = torch.maximum(m, sk)
            l = torch.exp(sk - m)
        e = torch.exp(sc - m[..., None])                 # 0 where masked
        parts.append((m, l + e.sum(dim=-1),
                      torch.einsum("skgc,sckd->skgd", e, v)))
    m_all = torch.stack([p[0] for p in parts]).amax(dim=0)
    l_sum = torch.zeros_like(m_all)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = torch.exp(m - m_all)         # an empty split: 0, or 1 times 0s
        l_sum = l_sum + l * w
        acc = acc + a * w[..., None]
    out = acc / l_sum.clamp(min=1e-30)[..., None]
    return out.reshape(S, qh, hd).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def splits_for(num_seqs: int, num_q_heads: int, num_kv_heads: int,
               reach: int, max_kv_len: Optional[int],
               sliding_window: Optional[int], device: torch.device) -> int:
    """The split count a launch on ``device`` takes: ``choose_splits`` at
    the hint ``max_kv_len`` (the page table's ``reach`` without one, and
    no more than the window needs). The engine keys its CUDA graphs by
    it."""
    bound = reach if max_kv_len is None else min(int(max_kv_len), reach)
    if sliding_window:
        bound = min(bound, int(sliding_window) + SPLIT_TILE)
    return choose_splits(num_seqs, num_kv_heads, bound,
                         _sm_count(device.index or 0),
                         num_q_heads // num_kv_heads)


def paged_decode_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                           kv_lens: torch.Tensor, page_indices: torch.Tensor,
                           *, sm_scale: float,
                           sliding_window: Optional[int] = None,
                           soft_cap: Optional[float] = None,
                           alibi_slopes: Optional[Sequence[float]] = None,
                           sinks: Optional[torch.Tensor] = None,
                           k_scale=None, v_scale=None,
                           max_kv_len: Optional[int] = None,
                           num_splits: Optional[int] = None,
                           count_as: Optional[str] = None) -> torch.Tensor:
    """q [S, qh, hd]; kv_pages [P, ps, 2*kvh, hd] in q's type, int8 or
    float8 e4m3; kv_lens i32[S]; page_indices i32[S, max_pages] -> out
    [S, qh, hd]. ``k_scale`` / ``v_scale`` dequantize an 8-bit pool (0-dim
    float32 tensors on q's device, or floats; None: 1).

    ``max_kv_len`` is a host-known upper bound of ``kv_lens`` (a hint: it
    only picks the number of KV splits, any value gives the same result);
    without it the bound is the page table's reach. ``num_splits`` forces
    the count (tests and sweeps). ``count_as`` names a second counter of
    this module that a launch also adds to (a route's own count)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, kv_pages, kv_lens, page_indices, sm_scale=sm_scale,
            sliding_window=sliding_window, soft_cap=soft_cap,
            alibi_slopes=alibi_slopes, sinks=sinks,
            num_splits=num_splits or 1, k_scale=k_scale, v_scale=v_scale)
    S, qh, hd = q.shape
    P, ps, combined, _ = kv_pages.shape
    kvh = combined // 2
    if q.device.type != "cuda" or kv_pages.device != q.device:
        raise ValueError("q and kv_pages must be on the same CUDA device")
    kv_dtype = kv_code(q.dtype, kv_pages.dtype)
    if hd not in HEAD_DIMS or qh % kvh:
        raise ValueError(f"unsupported geometry qh={qh} kvh={kvh} hd={hd}")
    if not (q.is_contiguous() and kv_pages.is_contiguous()):
        raise ValueError("q and kv_pages must be contiguous")
    kv_lens = kv_lens.to(torch.int32).contiguous()
    page_indices = page_indices.to(torch.int32).contiguous()
    sinks_t = _as_f32(sinks, q.device)
    alibi_t = _as_f32(alibi_slopes, q.device)
    ks, vs = scale_ptr(k_scale, q.device), scale_ptr(v_scale, q.device)
    splits = int(num_splits) if num_splits else splits_for(
        S, qh, kvh, page_indices.shape[1] * ps, max_kv_len, sliding_window,
        q.device)
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((S, qh, splits, hd), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((S, qh, splits, 2), dtype=torch.float32,
                              device=q.device)
    err = _kernel()(
        q.data_ptr(), kv_pages.data_ptr(), kv_lens.data_ptr(),
        page_indices.data_ptr(),
        sinks_t.data_ptr() if sinks_t is not None else None,
        alibi_t.data_ptr() if alibi_t is not None else None,
        out.data_ptr(),
        part_acc.data_ptr() if part_acc is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        S, qh, kvh, hd, ps, P, page_indices.shape[1],
        float(sm_scale), int(sliding_window or 0), float(soft_cap or 0.0),
        splits, _DTYPES[q.dtype], kv_dtype,
        ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if vs is not None else None,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    _build.count_launch(__name__)
    if count_as is not None:
        _build.count_launch(__name__, count_as)
    if sinks_t is not None:
        _build.count_launch(__name__, "LAUNCHES_SINKS")
    if alibi_t is not None:
        _build.count_launch(__name__, "LAUNCHES_ALIBI")
    return out
