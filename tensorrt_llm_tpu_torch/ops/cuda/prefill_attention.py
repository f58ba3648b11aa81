"""Causal ragged attention over the paged KV pool (prefill / mixed).

Replaces the TPU kernel ``ragged_prefill_attention``
(tensorrt_llm_tpu/ops/pallas/prefill_attention.py:250). The CUDA kernels
are in ``csrc/prefill_attention.cu``; every CTA owns disjoint output rows
and there is no cap on the segment length. At the timed shapes the
function's bytes and its tensor-core FLOPs are within 25 % of each other,
so the kernel has to run both products on the tensor cores. Two routes,
picked by the element type (``route_for``):

- bf16, ``tensor_core``: FlashAttention shape on Hopper's warpgroup MMA. A
  CTA is one warpgroup and owns 64 score rows (tokens x the query heads of
  one KV head); K and V tiles of 64 positions stay bf16 in shared memory,
  copied by cp.async into a ring in the swizzled layout wgmma reads;
  S = Q.K^T is wgmma from shared memory, the online softmax runs on the
  accumulator fragments in registers, and P goes from registers into the
  second wgmma, which reads V transposed; tiles are classified once
  (skipped, unmasked, edge); the longest causal spans start first.
- float32, ``float32_simple``: the first version's CUDA-core kernel,
  float32 math throughout (1e-4 against the plain version, which TF32
  would not hold).

Head dims 48, 64, 80, 96, 128 and 256 (80 and 96 staged as 128-wide
tiles and 48 as 64-wide ones, zero past the head dim, and read and written at their own width; at 256
one CTA per SM, and P.V as two n128 products per k-step); any other is
refused by name. A group of up to 64 query heads per KV head is one CTA's
rows (tokens x group); a larger one (Falcon-7B's 71 over 1) is cut into
equal chunks of at most 64 heads, one token per CTA. Left for later: a
TMA producer warp, softmax overlapped with the next tile's product, K/V
tiles shared between the query blocks of a sequence, a KV split for the
q_len-1 rows of mixed batches.

8-bit pools (int8, float8 e4m3; ``decode_attention.KV_DTYPES``), as in
the decode kernel: the plain version dequantizes as the JAX package does,
and the kernels copy the 8-bit tiles and dequantize them with the same
arithmetic into bf16 operand tiles in shared memory (wgmma reads bf16; q
stays bf16); the scales are device pointers.

Image groups (the image-group VLMs: Gemma 3's images, PaliGemma's whole
prompt): with ``q_groups`` (i32[T], -1 = none) and ``kv_group_pool`` (the
group id of every KV slot, read at ``(page % pool_pages) * ps +
offset``, so a layer's view of a flat all-layers pool folds back onto
the one group pool), a pair whose query group is >= 0 and equals the
key's is visible past the diagonal and outside the window, never past
kv_len (the JAX ``_reference_attention``'s or-mask, ops/attention.py:
568-586, which the JAX package serves only on its dense path). In the
kernels a CTA whose rows carry a group walks the whole KV range [0,
kv_len); a CTA without one walks its causal span as before. The mask is
compiled into a library of its own (``csrc/prefill_groups.cu``), launched
only for a call with groups, so a text step's kernels are the ones without
it; it takes pools of q's type (an 8-bit pool with groups is refused by
name). ``LAUNCHES_GROUPS`` counts the launches that carried groups.

``ragged_prefill_attention`` launches the kernel for CUDA tensors and runs
``ragged_prefill_attention_plain`` only for CPU tensors. ``LAUNCHES``
counts kernel launches (a captured launch once per replay of its graph).
The grid comes from ``max_q_len``, a host int: a CUDA graph fixes it for
its key (the rider window passes its chunk width), and CTAs past the end
of a shorter segment return at once.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from . import _build
from .decode_attention import (_DTYPES, HEAD_DIMS, _as_f32, dequant_kv,
                               kv_code, scale_ptr)

LAUNCHES = 0
# launches that carried attention sinks, and ALiBi slopes (counted with
# LAUNCHES, where the kernel launches)
LAUNCHES_SINKS = 0
LAUNCHES_ALIBI = 0
# launches with the image-group or-mask
LAUNCHES_GROUPS = 0
# launches over STAR's virtual sequences (ops/attention.py star_launches;
# counted with LAUNCHES, where the kernel launches)
LAUNCHES_STAR = 0


def route_for(dtype: torch.dtype) -> str:
    """The kernel route a CUDA tensor of ``dtype`` takes."""
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype}")
    return "tensor_core" if dtype == torch.bfloat16 else "float32_simple"


@functools.lru_cache(maxsize=None)
def _kernel(groups: bool = False):
    """The built C entry point (with the image-group or-mask: the
    ``prefill_groups`` library's), with its ctypes signature set once."""
    if groups:
        fn = _build.load("prefill_groups").ragged_prefill_attention_groups
    else:
        fn = _build.load("prefill_attention").ragged_prefill_attention
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P_] * 8 + [I_] * 8 + [F_, I_, F_, I_, I_, P_, P_, P_, P_,
                                         I_, P_]
    fn.restype = I_
    return fn


def ragged_prefill_attention_plain(q: torch.Tensor, kv_pages: torch.Tensor,
                                   kv_lens: torch.Tensor,
                                   page_indices: torch.Tensor,
                                   cu_q_lens: torch.Tensor, *,
                                   sm_scale: float,
                                   sliding_window: Optional[int] = None,
                                   soft_cap: Optional[float] = None,
                                   alibi_slopes: Optional[Sequence[float]]
                                   = None,
                                   sinks: Optional[torch.Tensor] = None,
                                   k_scale=None, v_scale=None,
                                   q_groups: Optional[torch.Tensor] = None,
                                   kv_group_pool: Optional[torch.Tensor]
                                   = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, one sequence at a time: gather
    the sequence's pages, dequantize an 8-bit pool (``dequant_kv``),
    causal + window mask OR the same-image-group pairs (``q_groups`` /
    ``kv_group_pool``), float32 softmax (sink logit in the denominator
    when given). Rows past cu_q_lens[S] are 0."""
    T, qh, hd = q.shape
    P, ps, combined, _ = kv_pages.shape
    kvh = combined // 2
    group = qh // kvh
    S = kv_lens.shape[0]
    out = torch.zeros_like(q)
    cu = cu_q_lens.tolist()
    kl = kv_lens.tolist()
    sl = _as_f32(alibi_slopes, q.device)
    sk = _as_f32(sinks, q.device)
    for s in range(S):
        q_len, kv_len = cu[s + 1] - cu[s], kl[s]
        if q_len <= 0:
            continue
        n_pages = -(-kv_len // ps)
        pids = page_indices[s, :n_pages].clamp(0, P - 1).long()
        pages = kv_pages[pids].reshape(n_pages * ps, combined, hd)[:kv_len]
        k = dequant_kv(pages[:, 0::2], k_scale, q.dtype).float()  # [kv, kvh, hd]
        v = dequant_kv(pages[:, 1::2], v_scale, q.dtype).float()
        qs = q[cu[s]:cu[s + 1]].float().reshape(q_len, kvh, group, hd)
        scores = torch.einsum("tkgd,ckd->kgtc", qs, k) * sm_scale
        q_pos = kv_len - q_len + torch.arange(q_len, device=q.device)
        pos = torch.arange(kv_len, device=q.device)
        if sl is not None:
            dist = (pos[None, :] - q_pos[:, None]).float()
            scores = scores + sl.reshape(kvh, group)[:, :, None, None] * dist
        if soft_cap is not None:
            scores = soft_cap * torch.tanh(scores / soft_cap)
        valid = pos[None, :] <= q_pos[:, None]
        if sliding_window is not None:
            valid &= pos[None, :] > q_pos[:, None] - sliding_window
        if q_groups is not None:
            gpages = kv_group_pool.numel() // ps
            slots = (pids % gpages)[:, None] * ps + torch.arange(
                ps, device=q.device)
            kg = kv_group_pool[slots.reshape(-1)[:kv_len]]
            gq = q_groups[cu[s]:cu[s + 1]]
            valid |= (gq[:, None] >= 0) & (gq[:, None] == kg[None, :])
        scores = scores.masked_fill(~valid, float("-inf"))
        m = scores.amax(dim=-1)                         # [kvh, g, t]
        if sk is not None:
            skr = sk.reshape(kvh, group, 1)
            m = torch.maximum(m, skr)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        e = torch.exp(scores - m[..., None])
        denom = e.sum(dim=-1)
        if sk is not None:
            denom = denom + torch.exp(skr - m)
        probs = e / denom.clamp(min=1e-30)[..., None]
        o = torch.einsum("kgtc,ckd->tkgd", probs, v)
        out[cu[s]:cu[s + 1]] = o.reshape(q_len, qh, hd).to(q.dtype)
    return out


def ragged_prefill_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                             kv_lens: torch.Tensor,
                             page_indices: torch.Tensor,
                             cu_q_lens: torch.Tensor, *,
                             sm_scale: float,
                             sliding_window: Optional[int] = None,
                             soft_cap: Optional[float] = None,
                             alibi_slopes: Optional[Sequence[float]] = None,
                             sinks: Optional[torch.Tensor] = None,
                             k_scale=None, v_scale=None,
                             max_q_len: Optional[int] = None,
                             q_groups: Optional[torch.Tensor] = None,
                             kv_group_pool: Optional[torch.Tensor] = None,
                             count_as: Optional[str] = None
                             ) -> torch.Tensor:
    """q [T, qh, hd] packed by cu_q_lens i32[S+1]; kv_pages
    [P, ps, 2*kvh, hd] in q's type, int8 or float8 e4m3; kv_lens i32[S];
    page_indices i32[S, max_pages] -> out [T, qh, hd]. ``k_scale`` /
    ``v_scale`` dequantize an 8-bit pool (0-dim float32 tensors on q's
    device, or floats; None: 1). ``max_q_len`` (the longest segment)
    sizes the grid; pass it from the host to avoid a device sync.
    ``q_groups`` i32[T] and ``kv_group_pool`` i32[pool_pages * ps]
    (together or not at all): the image-group or-mask. ``count_as`` names
    a second counter of this module that a launch also adds to (a route's
    own count)."""
    if (q_groups is None) != (kv_group_pool is None):
        raise ValueError("q_groups and kv_group_pool go together")
    if q.device.type == "cpu":
        return ragged_prefill_attention_plain(
            q, kv_pages, kv_lens, page_indices, cu_q_lens,
            sm_scale=sm_scale, sliding_window=sliding_window,
            soft_cap=soft_cap, alibi_slopes=alibi_slopes, sinks=sinks,
            k_scale=k_scale, v_scale=v_scale, q_groups=q_groups,
            kv_group_pool=kv_group_pool)
    T, qh, hd = q.shape
    P, ps, combined, _ = kv_pages.shape
    kvh = combined // 2
    S = kv_lens.shape[0]
    if q.device.type != "cuda" or kv_pages.device != q.device:
        raise ValueError("q and kv_pages must be on the same CUDA device")
    kv_dtype = kv_code(q.dtype, kv_pages.dtype)
    if hd not in HEAD_DIMS or qh % kvh:
        raise ValueError(f"unsupported geometry qh={qh} kvh={kvh} hd={hd}")
    if not (q.is_contiguous() and kv_pages.is_contiguous()):
        raise ValueError("q and kv_pages must be contiguous")
    kv_lens = kv_lens.to(torch.int32).contiguous()
    page_indices = page_indices.to(torch.int32).contiguous()
    cu_q_lens = cu_q_lens.to(torch.int32).contiguous()
    if max_q_len is None:
        max_q_len = int((cu_q_lens[1:] - cu_q_lens[:-1]).max())
    sinks_t = _as_f32(sinks, q.device)
    alibi_t = _as_f32(alibi_slopes, q.device)
    ks, vs = scale_ptr(k_scale, q.device), scale_ptr(v_scale, q.device)
    group_pages = 0
    if q_groups is not None:
        if q_groups.shape[0] < T or kv_group_pool.numel() % ps or \
                q_groups.device != q.device or \
                kv_group_pool.device != q.device:
            raise ValueError("q_groups must cover the T rows and the group "
                             "pool whole pages, on q's device")
        if kv_dtype:
            raise NotImplementedError(
                "the image-group or-mask on an 8-bit KV pool is not "
                "supported by this package")
        q_groups = q_groups.to(torch.int32).contiguous()
        kv_group_pool = kv_group_pool.to(torch.int32).contiguous()
        group_pages = kv_group_pool.numel() // ps
    out = torch.zeros_like(q)
    err = _kernel(q_groups is not None)(
        q.data_ptr(), kv_pages.data_ptr(), kv_lens.data_ptr(),
        page_indices.data_ptr(), cu_q_lens.data_ptr(),
        sinks_t.data_ptr() if sinks_t is not None else None,
        alibi_t.data_ptr() if alibi_t is not None else None,
        out.data_ptr(), S, qh, kvh, hd, ps, P, page_indices.shape[1],
        int(max_q_len), float(sm_scale), int(sliding_window or 0),
        float(soft_cap or 0.0), _DTYPES[q.dtype], kv_dtype,
        ks.data_ptr() if ks is not None else None,
        vs.data_ptr() if vs is not None else None,
        q_groups.data_ptr() if q_groups is not None else None,
        kv_group_pool.data_ptr() if q_groups is not None else None,
        group_pages, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "ragged_prefill_attention")
    _build.count_launch(__name__)
    if count_as is not None:
        _build.count_launch(__name__, count_as)
    if q_groups is not None:
        _build.count_launch(__name__, "LAUNCHES_GROUPS")
    if sinks_t is not None:
        _build.count_launch(__name__, "LAUNCHES_SINKS")
    if alibi_t is not None:
        _build.count_launch(__name__, "LAUNCHES_ALIBI")
    return out
