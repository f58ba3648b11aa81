"""Paged GQA decode attention (one query token per sequence).

Replaces the TPU kernel ``paged_decode_attention``
(tensorrt_llm_tpu/ops/pallas/decode_attention.py:164). The CUDA kernel is
``csrc/decode_attention.cu``: one CTA per (sequence, KV head), walking the
sequence's pages with a float32 online softmax. It is bound by the KV
bytes it reads (bytes / HBM bandwidth); the simple design leaves split-KV,
cp.async/TMA pipelining and tensor-core dot products for later.

``paged_decode_attention`` launches the kernel for CUDA tensors and runs
``paged_decode_attention_plain`` (gather the pages, then a masked softmax)
only for CPU tensors. ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from . import _build

LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _as_f32(x, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built C entry point, with its ctypes signature set once."""
    fn = _build.load("decode_attention").paged_decode_attention
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P_] * 7 + [I_] * 7 + [F_, I_, F_, I_, P_]
    fn.restype = I_
    return fn


def paged_decode_attention_plain(q: torch.Tensor, kv_pages: torch.Tensor,
                                 kv_lens: torch.Tensor,
                                 page_indices: torch.Tensor, *,
                                 sm_scale: float,
                                 sliding_window: Optional[int] = None,
                                 soft_cap: Optional[float] = None,
                                 alibi_slopes: Optional[Sequence[float]] = None,
                                 sinks: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: gather every page of the page
    table, mask positions past kv_len (and outside the window), softmax in
    float32 (with the sink logit in the denominator when given)."""
    S, qh, hd = q.shape
    P, ps, combined, _ = kv_pages.shape
    kvh = combined // 2
    group = qh // kvh
    max_kv = page_indices.shape[1] * ps
    pages = kv_pages[page_indices.clamp(0, P - 1).reshape(-1).long()]
    pages = pages.reshape(S, max_kv, combined, hd).float()
    k, v = pages[:, :, 0::2], pages[:, :, 1::2]          # [S, kv, kvh, hd]
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
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1)
    if sinks is not None:
        sk = _as_f32(sinks, q.device).reshape(1, kvh, group)
        m = torch.maximum(m, sk)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(scores - m[..., None])
    denom = e.sum(dim=-1)
    if sinks is not None:
        denom = denom + torch.exp(sk - m)
    probs = e / denom.clamp(min=1e-30)[..., None]
    out = torch.einsum("skgc,sckd->skgd", probs, v)
    return out.reshape(S, qh, hd).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                           kv_lens: torch.Tensor, page_indices: torch.Tensor,
                           *, sm_scale: float,
                           sliding_window: Optional[int] = None,
                           soft_cap: Optional[float] = None,
                           alibi_slopes: Optional[Sequence[float]] = None,
                           sinks: Optional[torch.Tensor] = None,
                           k_scale: Optional[float] = None,
                           v_scale: Optional[float] = None) -> torch.Tensor:
    """q [S, qh, hd]; kv_pages [P, ps, 2*kvh, hd]; kv_lens i32[S];
    page_indices i32[S, max_pages] -> out [S, qh, hd]."""
    global LAUNCHES
    if q.device.type == "cpu":
        if k_scale is not None or v_scale is not None:
            raise NotImplementedError("quantized KV pools are not supported")
        return paged_decode_attention_plain(
            q, kv_pages, kv_lens, page_indices, sm_scale=sm_scale,
            sliding_window=sliding_window, soft_cap=soft_cap,
            alibi_slopes=alibi_slopes, sinks=sinks)
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "the CUDA decode kernel has no int8/fp8 KV dequant yet")
    S, qh, hd = q.shape
    P, ps, combined, _ = kv_pages.shape
    kvh = combined // 2
    if q.device.type != "cuda" or kv_pages.device != q.device:
        raise ValueError("q and kv_pages must be on the same CUDA device")
    if q.dtype not in _DTYPES or kv_pages.dtype != q.dtype:
        raise TypeError(f"unsupported dtypes q={q.dtype} kv={kv_pages.dtype}")
    if hd not in (64, 128) or qh % kvh or qh // kvh > 64:
        raise ValueError(f"unsupported geometry qh={qh} kvh={kvh} hd={hd}")
    if not (q.is_contiguous() and kv_pages.is_contiguous()):
        raise ValueError("q and kv_pages must be contiguous")
    kv_lens = kv_lens.to(torch.int32).contiguous()
    page_indices = page_indices.to(torch.int32).contiguous()
    sinks_t = _as_f32(sinks, q.device)
    alibi_t = _as_f32(alibi_slopes, q.device)
    out = torch.empty_like(q)
    err = _kernel()(
        q.data_ptr(), kv_pages.data_ptr(), kv_lens.data_ptr(),
        page_indices.data_ptr(),
        sinks_t.data_ptr() if sinks_t is not None else None,
        alibi_t.data_ptr() if alibi_t is not None else None,
        out.data_ptr(), S, qh, kvh, hd, ps, P, page_indices.shape[1],
        float(sm_scale), int(sliding_window or 0), float(soft_cap or 0.0),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    LAUNCHES += 1
    return out
