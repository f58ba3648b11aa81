"""Paged attention for mixed prefill + decode batches.

Port of ``tensorrt_llm_tpu/ops/attention.py`` for the features a dense
model uses. All scheduled sequences' new tokens share one ragged token
axis. Each layer:

  1. ``write_kv`` scatters this step's K/V into the paged pool at
     ``slot_mapping`` (k at even combined-head indices, v at odd),
     quantizing them for an 8-bit pool (int8, float8 e4m3, or e4m3 on the
     NVFP4 grid) by the layer's scale;
  2. ``ragged_paged_attention`` attends over (kv_lens, page_indices,
     cu_q_lens). A decode-only batch goes to the paged decode kernel
     (ops/cuda/decode_attention.py), any other batch to the ragged
     prefill kernel (ops/cuda/prefill_attention.py); decode rows inside a
     mixed batch are q_len-1 segments of that kernel. This is the JAX
     package's ``hybrid_decode`` rule. The prefill kernel takes segments
     of any length, so there is no dense fallback for long segments.
     A step whose query rows carry an image group (``mm_grouped``: the
     image-group VLMs' prompt rows) always goes to the prefill kernel,
     which ORs same-group pairs into its mask; the JAX package sends such
     steps to its dense reference (ops/attention.py:394-402).
     A decode-only step the engine marks ``sparse_step`` goes, under a
     model's sparse config (ROCKET_TOPK / DSA), to the sparse route of
     ops/sparse_attention.py (the decode kernel on the selected pages);
     a prompt step under STAR goes to the prefill kernel over the
     virtual sequences of ``star_launches`` (block 0's pages followed by
     the row's own block's; under a sliding window one launch per window
     that the rows need), or to ``star_reference_attention`` (the STAR
     mask a sequence at a time) where the block size is not a whole
     number of pages.

``_reference_attention`` is the dense gather implementation of the same
semantics, kept for the tests. Both attention paths take ``k_scale`` /
``v_scale`` to dequantize an 8-bit pool, as the JAX package does
(``dequant_kv``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .cuda.decode_attention import (KV_DTYPES, dequant_kv,
                                    paged_decode_attention)
from .cuda.prefill_attention import ragged_prefill_attention
from .quant import fp4_round

E4M3_MAX = 448.0      # the largest finite float8 e4m3 value


@dataclasses.dataclass(frozen=True)
class AttentionMetadata:
    """Per-iteration ragged-batch metadata (device tensors), shared by
    every layer.

    Shapes (S = padded max sequences, T = padded token bucket,
    P = pages per sequence):
      kv_lens:        i32[S]   total KV length per seq incl. this step
      page_indices:   i32[S, P]
      cu_q_lens:      i32[S+1] cumulative new-token counts
      num_seqs:       i32[1]
      slot_mapping:   i32[T]   flat pool slot (page*page_size+offset) per
                      new token; out of range for padding (write dropped)
      positions:      i32[T]   absolute position of each new token
      logits_indices: i32[S]   token index of each sequence's last token
      max_q_len:      host int, the longest query segment (1 = decode-only
                      batch); None makes the dispatch read it from the
                      device (a sync).
      max_kv_len:     host int, an upper bound of kv_lens; None means the
                      page table's reach. The decode kernel picks its
                      number of KV splits from it (any value gives the
                      same result); the sparse route's indexer scores the
                      ordinals below it, and a sequence longer than the
                      bound has only its tail page scored past it.
      page_indices_sw, slot_mapping_sw: VSWA only (Gemma 2 with
                      ``max_attention_window``): the sliding layers' own
                      page table i32[S, P] and slots i32[T] in their
                      smaller pool; None for a single pool.
      seq_slots:      i32[S]   each row's sequence slot, -1 for padding
                      (the recurrent families index their state pools by
                      it, ops/ssm.py); None where no model reads it.
      positions_mrope: i32[3, T] M-RoPE's (temporal, height, width)
                      position of each new token (the M-RoPE models'
                      single steps); None elsewhere.
      rope_offset:    i32[T]   added to ``positions`` for the rotary
                      tables only (an M-RoPE sequence's ``mrope_delta``
                      in the decode windows, where all three axes hold
                      pos + delta and M-RoPE is plain RoPE there); None: 0.
      mm_groups_q:    i32[T]   each new token's image group, -1 for none
                      (the image-group VLMs, multimodal/gemma3_vl.py);
                      None elsewhere.
      mm_group_pool:  i32[pages * page_size] the persistent group id of
                      every KV slot (-1: none), layer-independent: a
                      layer's page ``l * P + i`` reads entry ``i``.
      mm_grouped:     host bool, some row of ``mm_groups_q`` is >= 0: the
                      or-mask applies (the kernels take the groups only
                      then, so a text step runs the causal code).
      cross_segments: host list of (first row, end row, sequence slot) of
                      each sequence of a prompt step (Mllama's
                      cross-attention reads the slot's vision state,
                      multimodal/mllama.py; slot -1: none); None
                      elsewhere.
      sparse_step:    host bool, the step is one the JAX engine runs on
                      its sparse path under a sparse config (a decode
                      step whose token bucket equals its row count, or a
                      K-step window without riders): its decode-only
                      attention may take the sparse route.
      star_segments:  STAR's prefill launches of a prompt step, for each
                      sliding window of the model's layers (None: global)
                      a tuple of ``StarLaunch`` (``star_metadata``); None
                      elsewhere.
      star_block_size: host int, a prompt step under STAR without the
                      remap (a block that is not a whole number of
                      pages): attention takes ``star_reference_attention``.
      pool_pages:     host (first page, pages) of the layer's part of a
                      flat all-layers pool (``layer_metadata``); None: the
                      table may name any page.
    """
    kv_lens: torch.Tensor
    page_indices: torch.Tensor
    cu_q_lens: torch.Tensor
    num_seqs: torch.Tensor
    slot_mapping: torch.Tensor
    positions: torch.Tensor
    logits_indices: torch.Tensor
    max_q_len: Optional[int] = None
    max_kv_len: Optional[int] = None
    page_indices_sw: Optional[torch.Tensor] = None
    slot_mapping_sw: Optional[torch.Tensor] = None
    seq_slots: Optional[torch.Tensor] = None
    positions_mrope: Optional[torch.Tensor] = None
    rope_offset: Optional[torch.Tensor] = None
    mm_groups_q: Optional[torch.Tensor] = None
    mm_group_pool: Optional[torch.Tensor] = None
    mm_grouped: bool = False
    cross_segments: Optional[list] = None
    sparse_step: bool = False
    star_segments: Optional[dict] = None
    star_block_size: Optional[int] = None
    pool_pages: Optional[tuple] = None

    def for_sliding_pool(self) -> "AttentionMetadata":
        """This metadata addressed at the sliding pool (VSWA); with
        ``layer_metadata`` at that pool's own page count."""
        return dataclasses.replace(
            self, page_indices=self.page_indices_sw,
            slot_mapping=self.slot_mapping_sw, page_indices_sw=None,
            slot_mapping_sw=None)


def layer_metadata(metadata: AttentionMetadata, layer_idx: int,
                   pages_per_layer: int, page_size: int,
                   num_layers: int) -> AttentionMetadata:
    """Metadata view addressing layer ``layer_idx`` of a flat all-layers
    pool ``[(L*P), ps, c, hd]``: layer l's pages sit at ``l*P + i``.
    Padding slots (encoded as >= P*ps) map to the flat pool's global
    out-of-range slot so their writes stay dropped."""
    per = pages_per_layer * page_size
    sm = torch.where(metadata.slot_mapping >= per, num_layers * per,
                     metadata.slot_mapping + layer_idx * per)
    star = metadata.star_segments
    if star is not None:
        off = layer_idx * pages_per_layer
        star = {w: tuple(ln._replace(page_indices=ln.page_indices + off)
                         for ln in launches)
                for w, launches in star.items()}
    return dataclasses.replace(
        metadata,
        page_indices=metadata.page_indices + layer_idx * pages_per_layer,
        slot_mapping=sm, star_segments=star,
        pool_pages=(layer_idx * pages_per_layer, pages_per_layer))


def quantize_kv(x: torch.Tensor, scale, dtype: torch.dtype,
                fp4_grid: bool = False) -> torch.Tensor:
    """K or V values of the compute type -> the pool's ``dtype``: divided
    by ``scale`` in float32 (when given), then for int8 rounded half to
    even and clipped to [-128, 127], or on the NVFP4 grid rounded to e2m1
    (``fp4_round``); e4m3 is clamped to +-448 before the cast. The JAX
    ``write_kv`` (ops/attention.py:200-213) stores the same bytes for
    values inside the range; outside it, its cast gives NaN (ml_dtypes
    saturates nothing), where this one stores +-448."""
    if scale is not None:
        x = x.float() / scale
        if dtype == torch.int8:
            x = torch.clamp(torch.round(x), -128, 127)
        elif fp4_grid:
            x = fp4_round(x)
    if dtype == torch.float8_e4m3fn:
        x = x.float().clamp(-E4M3_MAX, E4M3_MAX)
    return x.to(dtype)


def write_kv(kv_pages: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             slot_mapping: torch.Tensor, k_scale=None, v_scale=None,
             fp4_grid: bool = False) -> torch.Tensor:
    """Scatter new K/V into the paged pool, IN PLACE, and return the pool.

    kv_pages: [num_pages, page_size, 2*kv_heads, head_dim] (cache dtype)
    k, v:     [T, kv_heads, head_dim]
    slot_mapping: i32[T] flat slots; slots >= num_pages*page_size are
    dropped. The drop needs no host sync: a dropped row is redirected to
    the slot of the first kept row with that row's values (a duplicate
    write of identical data), or, when no row is kept, to slot 0 with the
    pool's own slot-0 contents.
    k_scale, v_scale: an 8-bit pool's scales (0-dim float32 tensors or
    floats), ``fp4_grid``: round to the NVFP4 grid (``quantize_kv``; K
    and V in one pass when they share a scale, as a layer's do). An 8-bit
    pool is scattered through its bytes (``index_copy_`` has no float8
    kernel).
    """
    num_pages, page_size, combined, head_dim = kv_pages.shape
    flat = kv_pages.view(num_pages * page_size, combined, head_dim)
    dt = kv_pages.dtype
    if k_scale is v_scale:
        kv = quantize_kv(torch.stack([k, v], dim=2), k_scale, dt, fp4_grid)
    else:
        kv = torch.stack([quantize_kv(k, k_scale, dt, fp4_grid).view(
            torch.uint8), quantize_kv(v, v_scale, dt, fp4_grid).view(
            torch.uint8)], dim=2).view(dt)
    kv = kv.reshape(k.shape[0], combined, head_dim)
    if kv_pages.element_size() == 1:
        flat, kv = flat.view(torch.uint8), kv.view(torch.uint8)
    scatter_slots(flat, kv, slot_mapping)
    return kv_pages


def scatter_slots(flat: torch.Tensor, rows: torch.Tensor,
                  slot_mapping: torch.Tensor) -> None:
    """``flat[slot_mapping[t]] = rows[t]`` IN PLACE for the slots inside
    ``flat``'s first axis; the others are dropped without a host sync: a
    dropped row is redirected to the slot of the first kept row with that
    row's values (a duplicate write of identical data), or, when no row
    is kept, to slot 0 with its own contents. ``write_kv``'s scatter, and
    MLA's latent write (models/deepseek.py)."""
    n = flat.shape[0]
    slots = slot_mapping.long()
    keep = (slots >= 0) & (slots < n)
    # the first kept row, as a 1-element index: indexing by a 0-dim
    # tensor would read it on the host (a sync, which a CUDA graph
    # capture refuses)
    first = torch.argmax(keep.to(torch.int8)).view(1)
    any_keep = keep.any()
    fb_slot = torch.where(any_keep, slots[first], 0)
    fb_val = torch.where(any_keep, rows[first], flat[:1])
    idx = torch.where(keep, slots, fb_slot)
    mask = keep.view((-1,) + (1,) * (rows.dim() - 1))
    flat.index_copy_(0, idx, torch.where(mask, rows, fb_val))


class StarLaunch(NamedTuple):
    """One prefill-kernel launch of a STAR prompt step (``star_launches``):
    its virtual sequences' kv_lens i32[Sv], cu_q_lens i32[Sv+1] and page
    table i32[Sv, P], host max_q_len, the sliding window it runs with
    (None: none), and the step's rows it attends (i64, ascending; None:
    every row, in order)."""
    kv_lens: Any
    cu_q_lens: Any
    page_indices: Any
    max_q_len: int
    window: Optional[int]
    rows: Any


def star_launches(cu_q_lens: np.ndarray, kv_lens: np.ndarray,
                  page_indices: np.ndarray, num_seqs: int, block: int,
                  page_size: int, window: Optional[int] = None) -> list:
    """STAR's prefill-kernel launches of a step for layers with sliding
    window ``window`` (host, numpy; a list of ``StarLaunch``). Under STAR
    (the JAX ``_reference_attention``'s mask, ops/attention.py:557-566) a
    prompt row in block b >= 1 attends block 0 and its own block up to
    itself, which is causal attention over a virtual sequence of block
    0's pages followed by block b's, whose length is block + (end - b *
    block) for rows that end at ``end``; a row in block 0 and a row of a
    one-token segment (a decode row) attend causally over their whole
    sequence. A chunk that crosses a block edge is cut into one virtual
    sequence per block. Needs ``block`` to be a whole number of pages.

    A window is measured in real positions. For blocks 0 and 1 the
    virtual positions are the real ones. A row in block b >= 2 at
    position pos is (b - 1) * block further from every block-0 key than
    in its virtual sequence: while pos < block + window it takes that
    sequence with the window shortened by (b - 1) * block (its own
    block's keys, at most pos - b * block back, all stay inside), and
    from block + window on no block-0 key is inside the window, so it
    takes its own block's pages alone with the window as it is. Each
    distinct window is one launch over the rows that need it; a single
    launch over every row keeps them in order (``rows`` None)."""
    if block % page_size:
        raise ValueError(f"STAR block {block} is not a whole number of "
                         f"{page_size}-token pages")
    P = page_indices.shape[1]
    bp = block // page_size
    cut = None if window is None else block + window
    groups: dict = {}            # window -> (lens, tables, cu, rows)

    def add(win, length, table, r0, r1):
        g = groups.setdefault(win, ([], [], [0], []))
        g[0].append(length)
        g[1].append(table)
        g[2].append(g[2][-1] + r1 - r0)
        g[3].extend(range(r0, r1))

    def table_of(*parts):
        t = np.zeros(P, np.int32)
        flat = np.concatenate(parts)
        t[:len(flat)] = flat
        return t
    for i in range(num_seqs):
        c0 = int(cu_q_lens[i])
        n = int(cu_q_lens[i + 1]) - c0
        L = int(kv_lens[i])
        if n <= 1:
            add(window, L, page_indices[i], c0, c0 + n)
            continue
        p = L - n
        while p < L:
            b = p // block
            end = min(L, (b + 1) * block)
            row = c0 + p - (L - n)
            if b == 0:
                add(window, end, page_indices[i], row, row + end - p)
                p = end
                continue
            own = page_indices[i, b * bp:-(-end // page_size)]
            mid = end if b == 1 or cut is None else min(end, max(p, cut))
            if mid > p:              # block 0, then the row's own block
                add(window if b == 1 or window is None
                    else window - (b - 1) * block,
                    block + mid - b * block,
                    table_of(page_indices[i, :bp], own), row, row + mid - p)
            if end > mid:            # the own block alone
                add(window, end - b * block, table_of(own),
                    row + mid - p, row + end - p)
            p = end
    if not groups:
        groups[window] = ([], [], [0], [])
    total = int(cu_q_lens[num_seqs])
    out = []
    for win, (lens, tables, cu, rows) in groups.items():
        cu_a = np.asarray(cu, np.int32)
        every = len(groups) == 1 and rows == list(range(total))
        out.append(StarLaunch(
            np.asarray(lens, np.int32), cu_a,
            np.stack(tables).astype(np.int32) if tables
            else np.zeros((0, P), np.int32),
            int(np.diff(cu_a).max()) if len(lens) else 0, win,
            None if every else np.asarray(rows, np.int64)))
    return out


def star_metadata(cu_q_lens: np.ndarray, kv_lens: np.ndarray,
                  page_indices: np.ndarray, num_seqs: int, block: int,
                  page_size: int, windows: Sequence, device) -> dict:
    """``AttentionMetadata.star_segments`` of a step: for each sliding
    window of the model's layers (None: global) its ``star_launches``,
    their arrays on ``device``."""
    def up(a):
        return None if a is None else torch.from_numpy(a).to(device)
    return {w: tuple(
        StarLaunch(up(ln.kv_lens), up(ln.cu_q_lens), up(ln.page_indices),
                   ln.max_q_len, ln.window, up(ln.rows))
        for ln in star_launches(cu_q_lens, kv_lens, page_indices,
                                num_seqs, block, page_size, window=w))
        for w in windows}


def _star_prefill(q: torch.Tensor, kv_pages: torch.Tensor, launches,
                  opts: dict) -> torch.Tensor:
    """The prefill kernel over a layer's STAR launches, each at its own
    window, counted as ``LAUNCHES_STAR``."""
    out = None
    for ln in launches:
        kw = dict(opts, sliding_window=ln.window)
        if ln.rows is None:
            return ragged_prefill_attention(
                q, kv_pages, ln.kv_lens, ln.page_indices, ln.cu_q_lens,
                max_q_len=max(ln.max_q_len, 1), count_as="LAUNCHES_STAR",
                **kw)
        if out is None:
            out = torch.zeros_like(q)
        out[ln.rows] = ragged_prefill_attention(
            q[ln.rows], kv_pages, ln.kv_lens, ln.page_indices, ln.cu_q_lens,
            max_q_len=max(ln.max_q_len, 1), count_as="LAUNCHES_STAR", **kw)
    return out


def ragged_paged_attention(q: torch.Tensor,            # [T, qh, hd]
                           kv_pages: torch.Tensor,     # [P, ps, 2kvh, hd]
                           metadata: AttentionMetadata,
                           *,
                           sm_scale: float,
                           sliding_window: Optional[int] = None,
                           soft_cap: Optional[float] = None,
                           alibi_slopes: Optional[Sequence[float]] = None,
                           sinks: Optional[torch.Tensor] = None,
                           k_scale=None, v_scale=None,
                           sparse_keep_pages: Optional[int] = None,
                           sparse_algo: str = "ROCKET_TOPK") -> torch.Tensor:
    """Mixed prefill/decode attention over the paged KV pool (``k_scale``
    / ``v_scale``: an 8-bit pool's scales, 0-dim float32 tensors on q's
    device or floats). ``sparse_keep_pages`` / ``sparse_algo``: the
    model's sparse config, which a decode-only ``sparse_step`` without a
    window, ALiBi, sinks or image groups takes (the JAX package's
    conditions, ops/attention.py:350-355)."""
    S = metadata.kv_lens.shape[0]
    T = q.shape[0]
    max_q = metadata.max_q_len
    if max_q is None:
        n = int(metadata.num_seqs[0])
        cu = metadata.cu_q_lens
        max_q = int((cu[1:n + 1] - cu[:n]).max()) if n else 0
    opts = dict(sm_scale=sm_scale, sliding_window=sliding_window,
                soft_cap=soft_cap, alibi_slopes=alibi_slopes, sinks=sinks,
                k_scale=k_scale, v_scale=v_scale)
    grouped = metadata.mm_grouped and metadata.mm_groups_q is not None \
        and metadata.mm_group_pool is not None
    if max_q <= 1 and not grouped:
        # decode-only batch: row i of q is sequence i's single token
        m = min(S, T)
        if sparse_keep_pages is not None and metadata.sparse_step and \
                sliding_window is None and alibi_slopes is None and \
                sinks is None:
            from .sparse_attention import sparse_paged_decode_attention
            out_s = sparse_paged_decode_attention(
                q[:m], kv_pages, metadata.kv_lens[:m],
                metadata.page_indices[:m], sm_scale=sm_scale,
                keep_pages=sparse_keep_pages, algo=sparse_algo,
                soft_cap=soft_cap, k_scale=k_scale, v_scale=v_scale,
                max_kv_len=metadata.max_kv_len,
                pool_pages=metadata.pool_pages)
        else:
            out_s = paged_decode_attention(
                q[:m], kv_pages, metadata.kv_lens[:m],
                metadata.page_indices[:m], max_kv_len=metadata.max_kv_len,
                **opts)
        if m == T:
            return out_s
        out = torch.zeros_like(q)
        out[:m] = out_s
        return out
    if metadata.star_block_size is not None:
        return star_reference_attention(
            q, kv_pages, metadata, star_block_size=metadata.star_block_size,
            **opts)
    if metadata.star_segments is not None:
        return _star_prefill(q, kv_pages,
                             metadata.star_segments[sliding_window], opts)
    if grouped:
        opts.update(q_groups=metadata.mm_groups_q,
                    kv_group_pool=metadata.mm_group_pool)
    return ragged_prefill_attention(
        q, kv_pages, metadata.kv_lens, metadata.page_indices,
        metadata.cu_q_lens, max_q_len=max(max_q, 1), **opts)


def _attend(qg, k, v, q_pos, kv_pos, valid, *, sm_scale, soft_cap=None,
            alibi_slopes=None, sinks=None) -> torch.Tensor:
    """Masked softmax attention in float32: qg [T, kvh, g, hd]; k, v
    [T, s, kvh, hd] (each row its own) or [s, kvh, hd] (shared by the
    rows); q_pos i64[T] and kv_pos i64[s] (ALiBi's distances); valid
    bool[T, s]. Out float32 [T, kvh, g, hd]; a fully masked row averages
    V, as in the JAX reference."""
    kvh, group = qg.shape[1:3]
    kk = "tskd" if k.dim() == 4 else "skd"
    scores = torch.einsum(f"tkgd,{kk}->tkgs", qg.float(),
                          k.float()) * sm_scale
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=qg.device).reshape(kvh, group)
        dist = (kv_pos[None, :] - q_pos[:, None]).float()
        scores = scores + slopes[None, :, :, None] * dist[:, None, None, :]
    if soft_cap is not None:
        scores = soft_cap * torch.tanh(scores / soft_cap)
    neg = torch.finfo(torch.float32).min
    scores = torch.where(valid[:, None, None, :], scores, neg)
    if sinks is not None:
        sk = torch.as_tensor(sinks, dtype=torch.float32,
                             device=qg.device).reshape(kvh, group)
        m = torch.maximum(scores.amax(dim=-1), sk[None])
        e = torch.exp(scores - m[..., None])
        denom = e.sum(dim=-1) + torch.exp(sk[None] - m)
        probs = e / denom[..., None]
    else:
        probs = torch.softmax(scores, dim=-1)
    return torch.einsum(f"tkgs,{kk}->tkgd", probs, v.float())


def _reference_attention(q, kv_pages, metadata, *, sm_scale,
                         sliding_window=None, soft_cap=None,
                         alibi_slopes=None, sinks=None, k_scale=None,
                         v_scale=None, star_block_size=None):
    """Dense gather-based paged attention, vectorized over sequences (the
    JAX package's ``_reference_attention`` for the dense-model features,
    the 8-bit pool's dequant, the STAR mask and the image-group or-mask
    included; a fully masked padding row averages V, as there). It copies
    every sequence's KV for each row: small steps only."""
    T, num_q_heads, head_dim = q.shape
    num_pages, page_size, combined, _ = kv_pages.shape
    num_kv_heads = combined // 2
    S, P = metadata.page_indices.shape
    max_kv = P * page_size
    cu = metadata.cu_q_lens.long()
    kv_lens = metadata.kv_lens.long()

    tok_idx = torch.arange(T, device=q.device)
    seq_of_tok = torch.searchsorted(cu[1:S + 1], tok_idx, right=True)
    seq_of_tok = seq_of_tok.clamp(max=S - 1)
    q_start = cu[seq_of_tok]
    q_lens = cu[1:S + 1] - cu[:S]
    tok_kv_pos = kv_lens[seq_of_tok] - q_lens[seq_of_tok] + (tok_idx - q_start)

    pages = kv_pages[metadata.page_indices.reshape(-1).long()]
    pages = pages.reshape(S, max_kv, combined, head_dim)
    k = dequant_kv(pages[:, :, 0::2], k_scale, q.dtype)
    v = dequant_kv(pages[:, :, 1::2], v_scale, q.dtype)
    kv_pos = torch.arange(max_kv, device=q.device)
    in_len = kv_pos[None, :] < kv_lens[seq_of_tok][:, None]
    valid = (kv_pos[None, :] <= tok_kv_pos[:, None]) & in_len
    if sliding_window is not None:
        valid &= kv_pos[None, :] > (tok_kv_pos[:, None] - sliding_window)
    if star_block_size is not None:
        # STAR (JAX ops/attention.py:557-566): a row of a segment longer
        # than one token attends the anchor block 0 and its own block;
        # rows of one-token segments (decode rows) attend globally
        q_blk = tok_kv_pos[:, None] // star_block_size
        kv_blk = kv_pos[None, :] // star_block_size
        local = (kv_blk == 0) | (kv_blk == q_blk)
        valid &= local | (q_lens[seq_of_tok] == 1)[:, None]
    if metadata.mm_group_pool is not None and \
            metadata.mm_groups_q is not None:
        # same-image pairs attend bidirectionally, past the diagonal and
        # outside the window, never past the length bound (JAX
        # ops/attention.py:568-586); the group pool is layer-independent,
        # so the modulo folds layer_metadata's l * P offset back
        pool2d = metadata.mm_group_pool.reshape(-1, page_size)
        kv_groups = pool2d[metadata.page_indices.reshape(-1).long()
                           % pool2d.shape[0]].reshape(S, max_kv)
        gq = metadata.mm_groups_q.long()
        bidir = (gq[:, None] >= 0) & (gq[:, None] == kv_groups[seq_of_tok])
        valid |= bidir & in_len
    qg = q.reshape(T, num_kv_heads, num_q_heads // num_kv_heads, head_dim)
    out = _attend(qg, k[seq_of_tok], v[seq_of_tok], tok_kv_pos, kv_pos,
                  valid, sm_scale=sm_scale, soft_cap=soft_cap,
                  alibi_slopes=alibi_slopes, sinks=sinks)
    return out.reshape(T, num_q_heads, head_dim).to(q.dtype)


# the float32 scores of the rows the plain STAR route attends at a time
STAR_PLAIN_CHUNK_BYTES = 256 << 20


def star_reference_attention(q, kv_pages, metadata, *, star_block_size,
                             sm_scale, sliding_window=None, soft_cap=None,
                             alibi_slopes=None, sinks=None, k_scale=None,
                             v_scale=None) -> torch.Tensor:
    """``_reference_attention`` with the STAR mask, a sequence at a time:
    the route of a STAR prompt step whose block is not a whole number of
    pages. A sequence's live KV is gathered and dequantized once, and its
    rows attend in chunks whose float32 scores stay under
    ``STAR_PLAIN_CHUNK_BYTES``, so the step holds one sequence's KV and
    one chunk's scores at a time. Reads cu_q_lens and kv_lens on the host
    (a prompt step runs eagerly); rows past the last sequence's come out
    0."""
    T, qh, hd = q.shape
    ps, combined = kv_pages.shape[1:3]
    kvh = combined // 2
    S = metadata.page_indices.shape[0]
    cu = metadata.cu_q_lens[:S + 1].tolist()
    lens = metadata.kv_lens[:S].tolist()
    out = torch.zeros_like(q)
    for s in range(S):
        c0, n, L = cu[s], cu[s + 1] - cu[s], lens[s]
        if n <= 0:
            continue
        ids = metadata.page_indices[s, :-(-L // ps)].long()
        pages = kv_pages[ids].reshape(-1, combined, hd)[:L]
        k = dequant_kv(pages[:, 0::2], k_scale, q.dtype).float()
        v = dequant_kv(pages[:, 1::2], v_scale, q.dtype).float()
        kv_pos = torch.arange(L, device=q.device)
        step = max(1, STAR_PLAIN_CHUNK_BYTES // (qh * L * 4))
        for a in range(0, n, step):
            b = min(n, a + step)
            q_pos = torch.arange(L - n + a, L - n + b, device=q.device)
            valid = kv_pos[None, :] <= q_pos[:, None]
            if sliding_window is not None:
                valid &= kv_pos[None, :] > q_pos[:, None] - sliding_window
            if n > 1:
                blk = kv_pos[None, :] // star_block_size
                valid &= (blk == 0) | \
                    (blk == q_pos[:, None] // star_block_size)
            o = _attend(q[c0 + a:c0 + b].reshape(b - a, kvh, qh // kvh, hd),
                        k, v, q_pos, kv_pos, valid, sm_scale=sm_scale,
                        soft_cap=soft_cap, alibi_slopes=alibi_slopes,
                        sinks=sinks)
            out[c0 + a:c0 + b] = o.reshape(b - a, qh, hd).to(q.dtype)
    return out
