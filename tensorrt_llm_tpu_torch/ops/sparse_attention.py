"""Top-k page-sparse decode attention: ROCKET_TOPK and DSA.

Port of ``tensorrt_llm_tpu/ops/sparse_attention.py``. For a decode-shaped
batch (one query per sequence) an index over each sequence's KV pages
scores every page, the top ``keep_pages`` ordinals are kept (page 0, the
attention sink, and the tail page, the local context, are always among
them), and exact attention runs over the kept pages only:

  * ROCKET_TOPK scores a page by the query against the page's mean key
    (the max over the KV head's query group and over the KV heads);
  * DSA scores it by the max over the page's head-0 keys at every second
    position, each projected to 32 dims by a fixed projection (the JAX
    package's ``jax.random.normal(PRNGKey(17), (hd, 32)) / sqrt(hd)``,
    rebuilt here from its counter-based generator, ``dsa_projection``),
    against the mean query projected alike.

``sparse_paged_decode_attention_plain`` is the JAX function in plain
float32 torch: every page of every sequence gathered, the selected pages'
keys and values gathered again, one softmax. It is the CPU reference.

``sparse_paged_decode_attention`` is the route the model runs: the
indexer in torch ops over at most the pages the step's KV bound reaches,
in chunks of pages whose copy stays under ``INDEXER_CHUNK_BYTES`` (so
that neither the step's memory nor a captured graph's pool grows with
the context; ROCKET_TOPK instead sums every page of the layer's part of
the pool in one pass when that part is no more than ``POOL_SUM_RATIO``
times the pages the table names, ``POOL_SUM_RATIO_8BIT`` on an 8-bit
pool), then the selection, then the decode kernel
(``ops/cuda/decode_attention.py``) on a compacted page table: the kept
pages in ordinal order, with the sequence's length in that table,
``(live kept pages) * page - (the tail page's unfilled slots, when the
tail page is kept)``. Attention over the compacted table equals the JAX
gather's: the kept pages are sorted by ordinal, every kept live page but
the tail is full, the tail is the highest live ordinal, and the softmax
does not depend on the order of its terms. The kernel is launched with
``max_kv_len`` = keep_pages * page, which sets its split count; on the
CPU its wrapper runs its plain version. Ties in the selection break
toward the lower ordinal, as ``jax.lax.top_k`` breaks them (with
``keep_pages`` = 1 the sink page is kept, not the tail page).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from .cuda.decode_attention import paged_decode_attention

ALGOS = ("ROCKET_TOPK", "DSA")
DSA_STRIDE = 2         # DSA scores every second position of a page
DSA_RANK = 32          # ... projected to this many dims
DSA_SEED = 17          # the JAX package's PRNGKey of the projection
# the float32 copy of one chunk of pages the card indexer reads at a time
INDEXER_CHUNK_BYTES = 64 << 20
# ROCKET_TOPK sums the layer's whole part of the pool, rather than
# gathering the table's pages, while that part holds at most this many
# times the table's entries. On an H100 at 32 rows x 8,192 positions
# (chip_smoke.py, indexer_paths) the one-pass sum of a bf16 pool stayed
# faster than the gather up to 8x (1.95 against 2.20 ms), and that of an
# 8-bit pool, widened to bf16 in chunks, up to 2x (2.73 against 3.02 ms;
# 3.95 against 3.01 at 3x)
POOL_SUM_RATIO = 8
POOL_SUM_RATIO_8BIT = 2


# --------------------------------------------------------------------- #
# DSA's fixed projection: jax.random.normal(PRNGKey(17), (hd, 32),
# float32) / sqrt(hd), with the threefry2x32 generator (the partitionable
# form, jax_threefry_partitionable=True) and XLA's float32 erfinv
# --------------------------------------------------------------------- #
def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1: int, k2: int, x1: np.ndarray, x2: np.ndarray):
    """Threefry-2x32 with 20 rounds over uint32 counter pairs (the
    generator of ``jax.random``)."""
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (np.uint32(k1), np.uint32(k2),
          np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        a, b = x1 + ks[0], x2 + ks[1]
        for i in range(5):
            for r in rotations[i % 2]:
                a = a + b
                b = _rotl(b, r) ^ a
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


# XLA's single-precision erfinv (Giles' approximation): the polynomial in
# w = -log(1 - x^2) - 2.5 below w = 5, in sqrt(w) - 3 above
_ERFINV_LOW = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HIGH = (-0.000200214257, 0.000100950558, 0.00134934322,
                -0.00367342844, 0.00573950773, -0.0076224613,
                0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    w = (-np.log1p(-x * x)).astype(np.float32)
    low = w < np.float32(5.0)
    w = np.where(low, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(low, np.float32(_ERFINV_LOW[0]),
                 np.float32(_ERFINV_HIGH[0])).astype(np.float32)
    for lo, hi in zip(_ERFINV_LOW[1:], _ERFINV_HIGH[1:]):
        p = (p * w + np.where(low, np.float32(lo),
                              np.float32(hi))).astype(np.float32)
    return (p * x).astype(np.float32)


def jax_normal(seed: int, shape: tuple) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape, float32)``:
    the counters are the flat index as (high, low) words, the bits the
    xor of threefry's two outputs, their top 23 bits the mantissa of a
    uniform in [-1 + ulp, 1), and sqrt(2) erfinv of that the normal."""
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = threefry2x32(seed >> 32, seed & 0xFFFFFFFF, hi, lo)
    mant = ((b1 ^ b2) >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    f = mant.view(np.float32) - np.float32(1.0)
    low = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(low, f * np.float32(2.0) + low).astype(np.float32)
    return (np.float32(math.sqrt(2.0)) * _erfinv_f32(u)).reshape(shape)


@functools.lru_cache(maxsize=None)
def dsa_projection(head_dim: int, rank: int = DSA_RANK,
                   seed: int = DSA_SEED) -> np.ndarray:
    """DSA's fixed projection, float32 [head_dim, rank] (the JAX
    ``dsa_page_scores``' default, ops/sparse_attention.py:74-75)."""
    return (jax_normal(seed, (head_dim, rank))
            / np.float32(head_dim ** 0.5)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _proj(head_dim: int, device: torch.device) -> torch.Tensor:
    """The projection on ``device``, made once: the first call of a
    captured step's body runs before its capture, so the capture reads
    this tensor and copies nothing from the host."""
    return torch.from_numpy(dsa_projection(head_dim)).to(device)


# --------------------------------------------------------------------- #
# Plain versions: the JAX functions in float32
# --------------------------------------------------------------------- #
def page_mean_keys(kv_pages: torch.Tensor, kv_lens: torch.Tensor,
                   page_indices: torch.Tensor,
                   page_size: int) -> torch.Tensor:
    """Mean key per (sequence, page ordinal): float32 [S, P, kvh, hd];
    positions past kv_len count for nothing (a partly filled tail page
    averages its filled prefix)."""
    S, P = page_indices.shape
    combined, hd = kv_pages.shape[2], kv_pages.shape[3]
    pages = kv_pages[page_indices.reshape(-1).long()]
    k = pages[:, :, 0::2, :].float().reshape(S, P, page_size,
                                             combined // 2, hd)
    pos = (torch.arange(P, device=k.device)[None, :, None] * page_size
           + torch.arange(page_size, device=k.device)[None, None, :])
    fill = (pos < kv_lens.long()[:, None, None]).float()
    n = fill.sum(dim=2).clamp(min=1.0)
    return (k * fill[..., None, None]).sum(dim=2) / n[..., None, None]


def dsa_page_scores(q: torch.Tensor, kv_pages: torch.Tensor,
                    kv_lens: torch.Tensor, page_indices: torch.Tensor,
                    page_size: int, *, stride: int = DSA_STRIDE,
                    proj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DSA's page scores, float32 [S, P]: the max, over a page's head-0
    keys at every ``stride``-th position below kv_len, of the projected
    key against the projected mean query (float32.min where none)."""
    S, P = page_indices.shape
    hd = kv_pages.shape[3]
    if proj is None:
        proj = _proj(hd, q.device)
    toks = kv_pages[page_indices.reshape(-1).long(), ::stride, 0, :]
    t = toks.shape[1]
    idx_k = toks.float().reshape(S, P * t, hd) @ proj
    # the JAX mean keeps q's type before the float32 cast
    idx_q = q.float().mean(dim=1).to(q.dtype).float() @ proj
    scores = torch.einsum("sr,sxr->sx", idx_q, idx_k).reshape(S, P, t)
    pos = (torch.arange(P, device=q.device)[None, :, None] * page_size
           + torch.arange(t, device=q.device)[None, None, :] * stride)
    neg = torch.finfo(torch.float32).min
    scores = torch.where(pos < kv_lens.long()[:, None, None], scores, neg)
    return scores.amax(dim=2)


def select_pages(page_score: torch.Tensor, kv_lens: torch.Tensor,
                 page_size: int, keep_pages: int):
    """(selected ordinals i64[S, K] in ascending order, their liveness
    bool[S, K]), K = min(keep_pages, P): pages past the sequence's last
    score float32.min, page 0 and the tail page float32.max, then the top
    K by a stable descending sort (ties toward the lower ordinal, as
    ``jax.lax.top_k``)."""
    S, P = page_score.shape
    K = min(keep_pages, P)
    used = (kv_lens.long() + page_size - 1) // page_size
    ordinal = torch.arange(P, device=page_score.device)[None, :]
    live = ordinal < used[:, None]
    big = torch.finfo(torch.float32).max
    score = torch.where(live, page_score.float(),
                        torch.finfo(torch.float32).min)
    tail = (used - 1).clamp(min=0)
    score = torch.where((ordinal == 0) | (ordinal == tail[:, None]), big,
                        score)
    top = torch.sort(score, dim=1, descending=True, stable=True).indices
    sel = torch.sort(top[:, :K], dim=1).values
    return sel, sel < used[:, None]


def _rocket_scores(q: torch.Tensor, mean_k: torch.Tensor,
                   k_scale) -> torch.Tensor:
    """ROCKET_TOPK's page scores [S, P] from mean keys [S, P, kvh, hd]:
    the max over KV heads and their query groups of q . mean key."""
    S, qh, hd = q.shape
    kvh = mean_k.shape[2]
    if k_scale is not None:
        mean_k = mean_k * k_scale
    qg = q.float().reshape(S, kvh, qh // kvh, hd)
    return torch.einsum("skgd,spkd->skgp", qg, mean_k).amax(dim=(1, 2))


def sparse_paged_decode_attention_plain(
        q: torch.Tensor, kv_pages: torch.Tensor, kv_lens: torch.Tensor,
        page_indices: torch.Tensor, *, sm_scale: float, keep_pages: int,
        algo: str = "ROCKET_TOPK", soft_cap: Optional[float] = None,
        k_scale=None, v_scale=None) -> torch.Tensor:
    """The JAX ``sparse_paged_decode_attention`` (ops/sparse_attention.py:
    98-164) in plain torch: q [S, qh, hd] (one query per sequence), the
    pool [pages, page, 2 kvh, hd] in q's type or 8 bits (``k_scale`` /
    ``v_scale``), float32 throughout, q's type out."""
    if algo not in ALGOS:
        raise ValueError(f"sparse algo {algo!r} is not one of {ALGOS}")
    S, P = page_indices.shape
    ps, combined, hd = kv_pages.shape[1:]
    kvh = combined // 2
    qh = q.shape[1]
    K = min(keep_pages, P)
    if algo == "DSA":
        page_score = dsa_page_scores(q, kv_pages, kv_lens, page_indices, ps)
    else:
        page_score = _rocket_scores(
            q, page_mean_keys(kv_pages, kv_lens, page_indices, ps), k_scale)
    sel, sel_live = select_pages(page_score, kv_lens, ps, keep_pages)
    sel_pages = torch.gather(page_indices.long(), 1, sel)
    pages = kv_pages[sel_pages.reshape(-1)].reshape(S, K * ps, combined, hd)
    k, v = pages[:, :, 0::2, :], pages[:, :, 1::2, :]
    k = k.float() * k_scale if k_scale is not None else k.float()
    v = v.float() * v_scale if v_scale is not None else v.float()
    kv_pos = (sel[:, :, None] * ps
              + torch.arange(ps, device=q.device)[None, None, :]
              ).reshape(S, K * ps)
    valid = (kv_pos < kv_lens.long()[:, None]) & \
        sel_live.repeat_interleave(ps, dim=1)
    qg = q.float().reshape(S, kvh, qh // kvh, hd)
    att = torch.einsum("skgd,sxkd->skgx", qg, k) * sm_scale
    if soft_cap is not None:
        att = soft_cap * torch.tanh(att / soft_cap)
    neg = torch.finfo(torch.float32).min
    att = torch.where(valid[:, None, None, :], att, neg)
    att = torch.softmax(att, dim=-1)
    att = torch.where(valid[:, None, None, :], att, 0.0)
    out = torch.einsum("skgx,sxkd->skgd", att, v)
    return out.reshape(S, qh, hd).to(q.dtype)


# --------------------------------------------------------------------- #
# The route: indexer in chunks, selection, K1 on the compacted table
# --------------------------------------------------------------------- #
def _chunk_pages(S: int, page_size: int, width: int) -> int:
    """Pages of every row read per chunk: their copy [S, pages, positions,
    width], at 4 bytes an element, stays under ``INDEXER_CHUNK_BYTES``."""
    return max(1, INDEXER_CHUNK_BYTES // (S * page_size * width * 4))


def page_scores(q: torch.Tensor, kv_pages: torch.Tensor,
                kv_lens: torch.Tensor, page_indices: torch.Tensor, *,
                algo: str, k_scale=None,
                pool_pages: Optional[tuple] = None) -> torch.Tensor:
    """The indexer's page scores float32 [S, P'] over the table's first
    P' = page_indices.shape[1] ordinals, with no copy of the whole KV:
    ROCKET_TOPK sums each page's keys in float32 and divides by the page
    size, then rewrites the tail page's score from the mean of its filled
    prefix alone; DSA projects the strided head-0 keys chunk by chunk.
    Equal to ``page_mean_keys`` / ``dsa_page_scores`` up to float32
    rounding. ROCKET_TOPK reads the table's pages in chunks (a gathered
    copy each), or, with ``pool_pages`` = (first page, pages) of the
    layer's part of the pool (every page the table can name) when that is
    at most ``POOL_SUM_RATIO`` (``POOL_SUM_RATIO_8BIT``) times the table's
    entries, sums every page of that part in one pass as it reads it and
    gathers the sums."""
    S, P = page_indices.shape
    ps, combined, hd = kv_pages.shape[1:]
    kvh = combined // 2
    dev = q.device
    table = page_indices.long()
    keys = kv_pages[:, :, 0::2, :]              # a view: K of every head
    out = []
    if algo == "DSA":
        proj = _proj(hd, dev)
        idx_q = q.float().mean(dim=1).to(q.dtype).float() @ proj
        heads = kv_pages[:, ::DSA_STRIDE, 0, :]  # [pages, t, hd] view
        t = heads.shape[1]
        step = _chunk_pages(S, t, hd)
        offs = torch.arange(t, device=dev) * DSA_STRIDE
        neg = torch.finfo(torch.float32).min
        for c0 in range(0, P, step):
            ids = table[:, c0:c0 + step]
            sc = torch.einsum("sr,sctr->sct", idx_q,
                              heads[ids].float() @ proj)
            pos = (torch.arange(c0, c0 + ids.shape[1], device=dev)
                   [None, :, None] * ps + offs[None, None, :])
            sc = torch.where(pos < kv_lens.long()[:, None, None], sc, neg)
            out.append(sc.amax(dim=2))
        return torch.cat(out, dim=1)
    # an 8-bit pool is widened to bf16 before the sum (no float8
    # reduction; bf16 holds every int8 and e4m3 value exactly); every pool
    # is summed in float32 as it is read
    wide = kv_pages.element_size() == 1

    def page_sums(k, dim):
        if wide:
            k = k.to(torch.bfloat16)
        return k.sum(dim=dim, dtype=torch.float32)
    ratio = POOL_SUM_RATIO_8BIT if wide else POOL_SUM_RATIO
    if pool_pages is not None and pool_pages[1] <= ratio * S * P:
        lo, n = pool_pages
        step = _chunk_pages(1, ps, kvh * hd) if wide else n
        sums = torch.cat([page_sums(keys[c0:c0 + step], 1)
                          for c0 in range(lo, lo + n, step)])  # [n, kvh, hd]
        step = _chunk_pages(S, 1, kvh * hd)
        for c0 in range(0, P, step):
            means = sums[table[:, c0:c0 + step] - lo] / ps
            out.append(_rocket_scores(q, means, k_scale))
    else:
        step = _chunk_pages(S, ps, kvh * hd)
        for c0 in range(0, P, step):
            means = page_sums(keys[table[:, c0:c0 + step]], 2) / ps
            out.append(_rocket_scores(q, means, k_scale))
    score = torch.cat(out, dim=1)
    # the tail page: the mean of its filled prefix only
    used = (kv_lens.long() + ps - 1) // ps
    tail = (used - 1).clamp(min=0)
    filled = (kv_lens.long() - tail * ps).clamp(min=1)
    tk = keys[torch.gather(table, 1, tail[:, None])[:, 0]].float()
    fill = (torch.arange(ps, device=dev)[None, :] < filled[:, None]).float()
    tmean = (tk * fill[:, :, None, None]).sum(dim=1) / \
        filled[:, None, None].float()
    tscore = _rocket_scores(q, tmean[:, None], k_scale)      # [S, 1]
    return score.scatter(1, tail[:, None], tscore)


def compact_pages(page_indices: torch.Tensor, kv_lens: torch.Tensor,
                  sel: torch.Tensor, sel_live: torch.Tensor,
                  page_size: int):
    """(page table i32[S, K] of the selected pages in ordinal order, each
    sequence's length i32[S] in that table): every kept live page is
    full but the tail page, which is the last kept one when it is kept."""
    table = torch.gather(page_indices.long(), 1, sel).to(torch.int32)
    kv = kv_lens.long()
    used = (kv + page_size - 1) // page_size
    tail_kept = (sel == (used - 1)[:, None]) & sel_live
    lens = sel_live.sum(dim=1) * page_size - \
        tail_kept.any(dim=1) * (used * page_size - kv)
    return table, lens.to(torch.int32)


def sparse_paged_decode_attention(
        q: torch.Tensor, kv_pages: torch.Tensor, kv_lens: torch.Tensor,
        page_indices: torch.Tensor, *, sm_scale: float, keep_pages: int,
        algo: str = "ROCKET_TOPK", soft_cap: Optional[float] = None,
        k_scale=None, v_scale=None, max_kv_len: Optional[int] = None,
        pool_pages: Optional[tuple] = None) -> torch.Tensor:
    """Sparse decode attention through the decode kernel: q [S, qh, hd],
    one query per sequence; ``max_kv_len`` (a host upper bound of
    kv_lens, the engine's) limits the indexer to the table's first
    R = ceil(max_kv_len / page) ordinals. A sequence longer than the
    bound keeps its tail page all the same: the tail takes ordinal R - 1
    and the pages between are no candidates. ``pool_pages``: the layer's
    part of the pool (``page_scores``). Launches the kernel on CUDA
    tensors (its launches also count as ``LAUNCHES_SPARSE``); on CPU
    tensors the kernel's wrapper runs its plain version."""
    if algo not in ALGOS:
        raise ValueError(f"sparse algo {algo!r} is not one of {ALGOS}")
    S, P = page_indices.shape
    ps = kv_pages.shape[1]
    reach = P if max_kv_len is None else \
        min(P, max(1, -(-int(max_kv_len) // ps)))
    table = page_indices[:, :reach]
    if reach < P:
        # the tail page of a sequence past the bound stands at ordinal
        # reach - 1 (a bound of every length changes nothing)
        kv = kv_lens.long()
        tail = ((kv + ps - 1) // ps - 1).clamp(min=0)
        past = tail >= reach
        last = torch.where(past, torch.gather(page_indices, 1,
                                              tail[:, None])[:, 0],
                           table[:, -1])
        table = torch.cat([table[:, :-1], last[:, None]], dim=1)
        kv_lens = torch.where(past, kv - (tail - reach + 1) * ps,
                              kv).to(kv_lens.dtype)
    score = page_scores(q, kv_pages, kv_lens, table, algo=algo,
                        k_scale=k_scale, pool_pages=pool_pages)
    sel, sel_live = select_pages(score, kv_lens, ps, keep_pages)
    ctable, clens = compact_pages(table, kv_lens, sel, sel_live, ps)
    return paged_decode_attention(
        q, kv_pages, clens, ctable, sm_scale=sm_scale, soft_cap=soft_cap,
        k_scale=k_scale, v_scale=v_scale,
        max_kv_len=sel.shape[1] * ps, count_as="LAUNCHES_SPARSE")

