"""Recurrent mixers over the flattened ragged batch: the depthwise causal
conv, the Mamba S6 selective scan, the Mamba2 SSD scan and the gated
delta rule.

Port of ``tensorrt_llm_tpu/ops/ssm.py`` (``_token_segments``,
``causal_conv1d``, ``selective_scan``, ``ssd_scan``, ``gated_delta_scan``).
None of these is a Pallas kernel in the JAX package (XLA compiles its
scans), so they are plain torch here.

State pools are indexed by sequence slot, not paged: each layer's view is
``[max_batch_size + 1, ...]`` float32, whose last row is the trash slot.
The functions write the slots' new states IN PLACE (``index_copy_``), so
captured CUDA graphs hold the pools' addresses; what the JAX functions
drop (``mode="drop"``: padding rows, ``seq_slots < 0``) lands in the trash
slot. A segment whose first position is > 0 continues from its slot's
state; one at position 0 starts fresh (the conv reads no state there, the
scans fold none in, the delta rule resets), so a recycled slot needs no
clearing.

Every scan has these forms (``form=``):

- ``"plain"``: the JAX function step for step, the CPU reference. The
  associative scans keep one state per token (``_assoc_scan``, the
  Hillis-Steele doubling of ``lax.associative_scan``'s combine), T x the
  state size of memory.
- ``"bounded"`` (the default for steps with a segment longer than one
  token): memory that does not grow as T x the state size.
  ``ssd_scan`` takes the chunked SSD form (transformers'
  ``Mamba2Mixer.torch_forward``): segments are cut into chunks of
  ``chunk`` tokens aligned to their starts, each chunk's output within
  itself comes from [chunk, chunk] decay-weighted products, and states
  exist per chunk only, passed between the chunks of a segment by one
  decay-weighted product over chunks; chunks are taken in groups that fit
  ``SSD_GROUP_BYTES``. ``selective_scan`` scans blocks of tokens of the
  flat axis (at most ``SCAN_BLOCK_BYTES`` of per-token states) and
  carries the state from block to block. ``gated_delta_scan`` steps
  through the positions of the segments, all segments at once: a loop
  of ``max_q_len`` rank-1 updates.
- ``"step"`` (the default when every segment has one token, the decode
  steps and windows): the one-step update, a multiply-add on each row's
  slot state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

# per-group budget of the chunked SSD form's [chunks, heads, Q, Q] tensors
SSD_GROUP_BYTES = 1 << 30
# per-block budget of the blocked selective scan's per-token states
SCAN_BLOCK_BYTES = 256 << 20
FORMS = ("plain", "bounded", "step")


class Segments(NamedTuple):
    """Per-token and per-row segment facts of a step (device tensors)."""
    seq_of: torch.Tensor       # i64[T] the token's batch row
    pos_in_seg: torch.Tensor   # i64[T]
    is_start: torch.Tensor     # bool[T]
    valid: torch.Tensor        # bool[T] a token of an active row
    slot_of: torch.Tensor      # i64[T] its slot's row; trash if not valid
    row_tgt: torch.Tensor      # i64[S] each row's slot; trash if inactive
    seg_len: torch.Tensor      # i64[S]
    last_tok: torch.Tensor     # i64[S] the row's last token (clipped >= 0)


def token_segments(metadata, T: int, trash: int) -> Segments:
    """The JAX ``_token_segments`` plus the slots: a token's row is the
    segment of ``cu_q_lens`` it falls in (padding past the last row's end
    counts as the last row's, and is not ``valid``). Rows at or past
    ``num_seqs`` and rows with ``seq_slots < 0`` map to ``trash``."""
    S = metadata.kv_lens.shape[0]
    dev = metadata.cu_q_lens.device
    cu = metadata.cu_q_lens.long()
    tok = torch.arange(T, device=dev)
    seq_of = torch.searchsorted(cu[1:S + 1].contiguous(), tok,
                                right=True).clamp(max=S - 1)
    pos_in_seg = tok - cu[seq_of]
    n = metadata.num_seqs.long().clamp(max=S)
    valid = tok < cu.gather(0, n)
    slots = metadata.seq_slots.long()
    active = (torch.arange(S, device=dev) < n) & (slots >= 0)
    row_tgt = torch.where(active, slots, trash)
    slot_of = torch.where(valid, row_tgt[seq_of], trash)
    seg_len = cu[1:S + 1] - cu[:S]
    last_tok = (cu[1:S + 1] - 1).clamp(min=0)
    return Segments(seq_of, pos_in_seg, pos_in_seg == 0, valid, slot_of,
                    row_tgt, seg_len, last_tok)


def _max_q_len(metadata) -> int:
    if metadata.max_q_len is not None:
        return int(metadata.max_q_len)
    cu = metadata.cu_q_lens
    return int((cu[1:] - cu[:-1]).max())


def _form(form: Optional[str], metadata) -> str:
    if form is None:
        return "step" if _max_q_len(metadata) <= 1 else "bounded"
    if form not in FORMS:
        raise ValueError(f"unknown scan form {form!r}; forms: {FORMS}")
    return form


def _assoc_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 0 with h_{-1} = 0, by doubling:
    ``lax.associative_scan`` with the combine (al ar, ar bl + br)."""
    T, d = b.shape[0], 1
    while d < T:
        b = torch.cat([b[:d], a[d:] * b[:-d] + b[d:]])
        a = torch.cat([a[:d], a[d:] * a[:-d]])
        d *= 2
    return b


# ---------------------------------------------------------------------- #
# Causal depthwise conv
# ---------------------------------------------------------------------- #
def causal_conv1d(x: torch.Tensor,            # [T, I]
                  conv_w: torch.Tensor,       # [I, k]
                  conv_b: torch.Tensor,       # [I]
                  conv_state: torch.Tensor,   # [slots + 1, I, k-1]
                  metadata) -> torch.Tensor:
    """Depthwise causal conv with cross-step state: float32 [T, I]. The
    slots' windows of the last k-1 inputs (oldest first) are written in
    place. Taps before a segment's start read the slot's window when the
    position allows it, else zero (the JAX ``causal_conv1d``)."""
    T, I = x.shape
    k = conv_w.shape[1]
    trash = conv_state.shape[0] - 1
    seg = token_segments(metadata, T, trash)
    xf = x.float()
    w = conv_w.float()
    pos = metadata.positions.long()
    out = xf * w[:, k - 1]
    for j in range(1, k):
        in_seg = (seg.pos_in_seg >= j)[:, None]
        x_j = F.pad(xf[:-j], (0, 0, j, 0)) if j < T else torch.zeros_like(xf)
        m = j - seg.pos_in_seg - 1                   # steps into the window
        idx = (k - 2 - m).clamp(0, k - 2)
        s_j = conv_state[seg.slot_of, :, idx].float()
        have = ((pos - j) >= 0)[:, None]
        contrib = torch.where(in_seg, x_j, torch.where(
            have, s_j, torch.zeros((), device=x.device)))
        out = out + contrib * w[:, k - 1 - j]
    out = out + conv_b.float()

    # each row's new window: its last k-1 inputs, reaching into the old
    # window where the segment is shorter
    last = seg.last_tok
    cols = []
    for j in range(k - 2, -1, -1):                   # j steps back
        x_j = xf[(last - j).clamp(min=0)]
        m = j - (seg.seg_len - 1) - 1
        idx = (k - 2 - m).clamp(0, k - 2)
        old = conv_state[seg.row_tgt, :, idx].float()
        have = ((pos[last] - j) >= 0)[:, None]
        cols.append(torch.where((seg.seg_len > j)[:, None], x_j, torch.where(
            have, old, torch.zeros((), device=x.device))))
    new = torch.stack(cols, dim=-1).to(conv_state.dtype)
    conv_state.index_copy_(0, seg.row_tgt, new)
    return out


# ---------------------------------------------------------------------- #
# Mamba S6 selective scan
# ---------------------------------------------------------------------- #
def selective_scan(x: torch.Tensor,          # [T, I] post-conv activation
                   dt: torch.Tensor,         # [T, I]
                   A: torch.Tensor,          # [I, N]
                   B: torch.Tensor,          # [T, N]
                   C: torch.Tensor,          # [T, N]
                   D: torch.Tensor,          # [I]
                   ssm_state: torch.Tensor,  # [slots + 1, I, N]
                   metadata, form: Optional[str] = None) -> torch.Tensor:
    """y_t = C_t . h_t + D x_t with h_t = exp(dt A) h_{t-1} + dt B_t x_t
    (in x's type); each row's final state lands in its slot in place."""
    T = x.shape[0]
    trash = ssm_state.shape[0] - 1
    seg = token_segments(metadata, T, trash)
    form = _form(form, metadata)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = B.float(), C.float()
    cont = seg.is_start & (metadata.positions > 0)
    if form == "step":
        h = _step_decay(ssm_state, seg.slot_of, cont,
                        torch.exp(dtf[:, :, None] * Af),
                        (dtf * xf)[:, :, None], Bf[:, None, :])
        ssm_state.index_copy_(0, seg.slot_of, h.to(ssm_state.dtype))
        y = torch.einsum("tin,tn->ti", h, Cf)
        return (y + D.float() * xf).to(x.dtype)
    if form == "plain":
        dA = torch.exp(dtf[:, :, None] * Af)
        dBx = (dtf * xf)[:, :, None] * Bf[:, None, :]
        h_init = ssm_state[seg.slot_of].float()
        b0 = torch.where(cont[:, None, None], dA * h_init + dBx, dBx)
        a0 = torch.where(seg.is_start[:, None, None],
                         torch.zeros_like(dA), dA)
        h = _assoc_scan(a0, b0)
        y = torch.einsum("tin,tn->ti", h, Cf)
        final = h[seg.last_tok]
    else:
        y, final = _selective_blocks(xf, dtf, Af, Bf, Cf, ssm_state, seg,
                                     cont)
    ssm_state.index_copy_(0, seg.row_tgt, final.to(ssm_state.dtype))
    return (y + D.float() * xf).to(x.dtype)


def _step_decay(state, slot_of, cont, dA, u, v):
    """One token a segment: h = dA h_slot + u v where the segment
    continues, else u v (u and v broadcast to the state's shape). The
    gathered states are decayed and added to in place, and the product u
    v is never materialised: the state crosses memory four times (the
    gather's read and write, each in-place op's)."""
    h = state[slot_of].float()
    shape = (-1,) + (1,) * (dA.dim() - 1)
    h.mul_(torch.where(cont.view(shape), dA, torch.zeros((), device=dA.device)))
    return h.addcmul_(u, v)


def _selective_blocks(xf, dtf, Af, Bf, Cf, ssm_state, seg, cont):
    """The selective scan over blocks of the flat token axis, each block
    an associative scan whose first token folds in the state carried from
    the block before (unless it starts a segment): (y [T, I], the rows'
    final states [S, I, N])."""
    T, I = xf.shape
    N = Af.shape[1]
    S = seg.row_tgt.shape[0]
    Qb = max(1, min(T, SCAN_BLOCK_BYTES // (4 * 4 * I * N)))
    carry = torch.zeros(I, N, device=xf.device)
    final = torch.zeros(S, I, N, device=xf.device)
    ys = []
    for b0 in range(0, T, Qb):
        b1 = min(T, b0 + Qb)
        sl = slice(b0, b1)
        dA = torch.exp(dtf[sl, :, None] * Af)
        dBx = (dtf[sl] * xf[sl])[:, :, None] * Bf[sl, None, :]
        start = seg.is_start[sl]
        # segment starts fold in their slot's state where they continue
        # (gathered for the block's tokens only)
        h_init = ssm_state[torch.where(cont[sl], seg.slot_of[sl],
                                       ssm_state.shape[0] - 1)].float()
        b = torch.where(cont[sl, None, None], dA * h_init + dBx, dBx)
        # the block's first token continues the carried state
        if b0 > 0:
            b[0] = torch.where(start[0], b[0], dA[0] * carry + b[0])
        a = torch.where(start[:, None, None], torch.zeros_like(dA), dA)
        a[0] = 0
        h = _assoc_scan(a, b)
        ys.append(torch.einsum("tin,tn->ti", h, Cf[sl]))
        inside = (seg.last_tok >= b0) & (seg.last_tok < b1)
        final = torch.where(inside[:, None, None],
                            h[(seg.last_tok - b0).clamp(0, b1 - b0 - 1)],
                            final)
        carry = h[-1]
    return torch.cat(ys), final


# ---------------------------------------------------------------------- #
# Mamba2 SSD scan
# ---------------------------------------------------------------------- #
def ssd_scan(x: torch.Tensor,          # [T, nh, hd] post-conv activation
             dt: torch.Tensor,         # [T, nh] post softplus + clamp
             A: torch.Tensor,          # [nh] (negative)
             B: torch.Tensor,          # [T, G, N]
             C: torch.Tensor,          # [T, G, N]
             D: torch.Tensor,          # [nh]
             ssm_state: torch.Tensor,  # [slots + 1, nh, hd, N]
             metadata, form: Optional[str] = None,
             chunk: int = 256) -> torch.Tensor:
    """Mamba2 SSD: h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t (x) B_t,
    y_t = h_t . C_t + D x_t, scalar decay per head and B/C shared by
    groups of heads (in x's type); each row's final state lands in its
    slot in place. ``chunk``: the bounded form's chunk length."""
    T, nh, hd = x.shape
    G = B.shape[1]
    rep = nh // G
    trash = ssm_state.shape[0] - 1
    seg = token_segments(metadata, T, trash)
    form = _form(form, metadata)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = B.float(), C.float()
    cont = seg.is_start & (metadata.positions > 0)
    if form == "bounded":
        y, final = _ssd_chunked(xf, dtf, Af, Bf, Cf, ssm_state, seg, cont,
                                metadata, chunk)
        ssm_state.index_copy_(0, seg.row_tgt, final.to(ssm_state.dtype))
        return (y + D.float()[None, :, None] * xf).to(x.dtype)
    Bh = Bf.repeat_interleave(rep, dim=1)                  # [T, nh, N]
    Ch = Cf.repeat_interleave(rep, dim=1)
    dA = torch.exp(dtf * Af)[:, :, None, None]             # [T, nh, 1, 1]
    if form == "step":
        h = _step_decay(ssm_state, seg.slot_of, cont, dA,
                        (dtf[:, :, None] * xf)[..., None],
                        Bh[:, :, None, :])
        ssm_state.index_copy_(0, seg.slot_of, h.to(ssm_state.dtype))
    else:
        dBx = (dtf[:, :, None] * xf)[..., None] * Bh[:, :, None, :]
        h_init = ssm_state[seg.slot_of].float()
        b0 = torch.where(cont[:, None, None, None], dA * h_init + dBx, dBx)
        a0 = torch.where(seg.is_start[:, None, None, None],
                         torch.zeros_like(dA), dA)
        h = _assoc_scan(a0, b0)
        ssm_state.index_copy_(0, seg.row_tgt,
                              h[seg.last_tok].to(ssm_state.dtype))
    y = torch.einsum("thdn,thn->thd", h, Ch)
    return (y + D.float()[None, :, None] * xf).to(x.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """[..., Q] -> [..., Q, Q]: out[i, j] = sum of a over (j, i] for j <= i,
    -inf above the diagonal (transformers' ``segment_sum``, stable: a
    masked cumulative sum, not a difference of cumulative sums)."""
    Q = a.shape[-1]
    x = a[..., None].expand(*a.shape, Q)                  # [..., k, j]
    below = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device),
                       -1)
    x = x.masked_fill(~below, 0).cumsum(dim=-2)
    keep = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, float("-inf"))


def _ssd_chunked(xf, dtf, Af, Bf, Cf, ssm_state, seg, cont, metadata,
                 Q: int):
    """The chunked SSD form over the ragged batch: (y [T, nh, hd] without
    the D term, the rows' final states [S, nh, hd, N]).

    Row s's tokens fill chunks ``base[s] .. base[s] + nch[s] - 1`` of Q
    slots each, aligned to the segment's start; unused slots keep dt = 0,
    an identity step. The chunk axis is sized NC = ceil(T/Q) + S, the
    most any step needs, plus one chunk that takes the tokens of no row.
    Between chunks, entries [slot state of s, chunk states of s ...] per
    row pass states by one decay-weighted product over entries (the
    transformers form, with a row's entries masked off from the
    others')."""
    T, nh, hd = xf.shape
    G, N = Bf.shape[1], Bf.shape[2]
    rep = nh // G
    S = seg.row_tgt.shape[0]
    dev = xf.device
    NC = -(-T // Q) + S
    nch = (seg.seg_len + Q - 1) // Q                       # [S]
    base = torch.cumsum(nch, 0) - nch                      # exclusive
    chunk_of = torch.where(seg.valid, base[seg.seq_of] + seg.pos_in_seg // Q,
                           NC)
    flat = chunk_of * Q + seg.pos_in_seg % Q               # [T]

    def lay(v):
        out = torch.zeros(((NC + 1) * Q,) + tuple(v.shape[1:]), device=dev)
        out.index_copy_(0, flat, v)
        return out.view((NC + 1, Q) + tuple(v.shape[1:]))[:NC]

    DT = lay(dtf)                                          # [NC, Q, nh]
    Xd = lay(dtf[:, :, None] * xf).view(NC, Q, G, rep, hd)
    Bc = lay(Bf)                                           # [NC, Q, G, N]
    Cc = lay(Cf)
    Acs = torch.cumsum(DT * Af, dim=1)                     # [NC, Q, nh]

    # within chunks: y_diag and each chunk's state at its end, in groups
    # of chunks whose [heads, Q, Q] tensors fit the budget
    per_chunk = 3 * 4 * nh * Q * Q
    gs = max(1, SSD_GROUP_BYTES // per_chunk)
    y_diag = torch.empty(NC, Q, G, rep, hd, device=dev)
    states = torch.empty(NC, G, rep, hd, N, device=dev)
    for c0 in range(0, NC, gs):
        c1 = min(NC, c0 + gs)
        dA = (DT[c0:c1] * Af).permute(0, 2, 1)             # [g, nh, Q]
        L = torch.exp(_segsum(dA)).view(c1 - c0, G, rep, Q, Q)
        CB = torch.einsum("cign,cjgn->cgij", Cc[c0:c1], Bc[c0:c1])
        y_diag[c0:c1] = torch.einsum("cgrij,cjgrd->cigrd",
                                     CB[:, :, None] * L, Xd[c0:c1])
        acs = Acs[c0:c1]
        decay = torch.exp(acs[:, -1:] - acs).view(c1 - c0, Q, G, rep, 1)
        states[c0:c1] = torch.einsum("cjgn,cjgrd->cgrdn", Bc[c0:c1],
                                     decay * Xd[c0:c1])

    # between chunks: entries [slot state, chunks...] per row
    NE = NC + S
    row = torch.arange(S, device=dev)
    ebase = base + row                                     # [S]
    chunk_row = torch.searchsorted(torch.cumsum(nch, 0),
                                   torch.arange(NC, device=dev), right=True)
    used = chunk_row < S
    chunk_row = chunk_row.clamp(max=S - 1)
    entry_of_chunk = torch.arange(NC, device=dev) + chunk_row + 1
    e_row = torch.full((NE + 1,), -1, dtype=torch.long, device=dev)
    e_tot = torch.zeros(NE + 1, nh, device=dev)
    e_state = torch.zeros(NE + 1, G, rep, hd, N, device=dev)
    dump = torch.where(used, entry_of_chunk, NE)
    e_row.index_copy_(0, dump, torch.where(used, chunk_row, -1))
    e_tot.index_copy_(0, dump, Acs[:, -1])
    e_state.index_copy_(0, dump, states)
    first_tok = metadata.cu_q_lens[:S].long().clamp(max=T - 1)
    cont_row = cont[first_tok] & (seg.seg_len > 0)
    h_slot = ssm_state[seg.row_tgt].float().view(S, G, rep, hd, N)
    e_row.index_copy_(0, ebase, row)
    e_state.index_copy_(0, ebase, torch.where(
        cont_row[:, None, None, None, None], h_slot, torch.zeros_like(h_slot)))
    e_row, e_tot, e_state = e_row[:NE], e_tot[:NE], e_state[:NE]
    same = (e_row[:, None] == e_row[None, :]) & (e_row[:, None] >= 0)
    # decay[z, e] = exp(sum of e_tot over (e, z]) within a row
    ss = _segsum(e_tot.t())                                # [nh, NE, NE]
    dec = torch.exp(ss.masked_fill(~same, float("-inf")))
    new = torch.einsum("hze,ehd->zhd", dec,
                       e_state.view(NE, nh, hd * N)).view(NE, nh, hd, N)
    # the state entering each chunk is its entry's predecessor's
    h_in = new[(entry_of_chunk - 1).clamp(max=NE - 1)]
    h_in = h_in.view(NC, G, rep, hd, N)
    y_off = torch.einsum("cign,cgrdn->cigrd", Cc, h_in) * \
        torch.exp(Acs).view(NC, Q, G, rep)[..., None]
    y = (y_diag + y_off).reshape(NC * Q, nh, hd)
    out = y[flat.clamp(max=NC * Q - 1)]
    out = torch.where(seg.valid[:, None, None], out, torch.zeros_like(out))
    final = new[(ebase + nch).clamp(max=NE - 1)]
    return out, final


# ---------------------------------------------------------------------- #
# Gated delta rule
# ---------------------------------------------------------------------- #
def gated_delta_scan(q: torch.Tensor,        # [T, vh, dk] post l2norm+scale
                     k: torch.Tensor,        # [T, vh, dk] post l2norm
                     v: torch.Tensor,        # [T, vh, dv]
                     g: torch.Tensor,        # [T, vh] log-decay (<= 0)
                     beta: torch.Tensor,     # [T, vh] in (0, 1)
                     state: torch.Tensor,    # [slots + 1, vh, dk, dv]
                     metadata, form: Optional[str] = None) -> torch.Tensor:
    """The gated delta rule (Qwen3-Next's linear attention):
    S_t = S_{t-1} exp(g_t); delta = (v_t - k_t . S_t) beta_t;
    S_t += k_t (x) delta; y_t = q_t . S_t, in q's type. A segment at
    position 0 starts from zero, a later one from its slot's state; the
    final states land in their slots in place.

    ``"plain"`` walks the flat token axis one token at a time over the
    slots' states (the JAX ``lax.scan``); ``"bounded"`` and ``"step"``
    walk the segments' positions, every segment at once (one iteration
    for a decode step)."""
    T = q.shape[0]
    trash = state.shape[0] - 1
    seg = token_segments(metadata, T, trash)
    form = _form(form, metadata)
    qf, kf, vf = q.float(), k.float(), v.float()
    gf, bf = torch.exp(g.float()), beta.float()
    fresh = seg.is_start & (metadata.positions == 0)
    if form == "plain":
        st = state.float().clone()
        ys = []
        for t in range(T):
            idx = seg.slot_of[t:t + 1]
            s = st.index_select(0, idx)[0]
            s = torch.where(fresh[t], torch.zeros_like(s), s)
            s, y = _delta_update(s[None], qf[t:t + 1], kf[t:t + 1],
                                 vf[t:t + 1], gf[t:t + 1], bf[t:t + 1])
            st.index_copy_(0, idx, s)
            ys.append(y)
        state.copy_(st.to(state.dtype))
        return torch.cat(ys).to(q.dtype)
    S = seg.row_tgt.shape[0]
    cu = metadata.cu_q_lens.long()
    P = 1 if form == "step" else _max_q_len(metadata)
    s = state[seg.row_tgt].float()                         # [S, vh, dk, dv]
    first = cu[:S].clamp(max=T - 1)
    s = torch.where(fresh[first][:, None, None, None], torch.zeros_like(s),
                    s)
    y = torch.zeros(T + 1, *v.shape[1:], device=q.device)
    for p in range(P):
        live = p < seg.seg_len                             # [S]
        t = torch.where(live, cu[:S] + p, T).clamp(max=T)
        tt = t.clamp(max=T - 1)
        s_new, y_p = _delta_update(s, qf[tt], kf[tt], vf[tt], gf[tt],
                                   bf[tt])
        s = torch.where(live[:, None, None, None], s_new, s)
        y.index_copy_(0, t, torch.where(live[:, None, None], y_p,
                                        torch.zeros_like(y_p)))
    state.index_copy_(0, seg.row_tgt, s.to(state.dtype))
    return y[:T].to(q.dtype)


def _delta_update(s, q, k, v, g, b):
    """One delta-rule step on states s [n, vh, dk, dv] with one token's
    q/k [n, vh, dk], v [n, vh, dv], decay g and beta [n, vh]:
    (new states, y [n, vh, dv])."""
    s = s * g[:, :, None, None]
    kv_mem = torch.einsum("nhk,nhkv->nhv", k, s)
    delta = (v - kv_mem) * b[:, :, None]
    s = s + k[:, :, :, None] * delta[:, :, None, :]
    return s, torch.einsum("nhk,nhkv->nhv", q, s)
