"""Device-resident speculative decode window (one-model EAGLE3 or MTP).

Port of ``tensorrt_llm_tpu/runtime/spec_window.py``. The head is the
drafter's (speculative/eagle.py ``Eagle3Drafter``, speculative/mtp.py
``MtpDrafter``), the two signatures normalised by
``speculative.one_model.head_step``; the head pool's entry is the
drafter's ``kv_entry_shape`` ([2 * kv heads, head dim] for EAGLE3, the
MLA latent [kv_lora_rank + qk_rope_head_dim] for MTP). The whole
propose -> verify -> accept loop is one dispatch, iterated K times, so
speculative decoding rides the overlap scheduler and pays the host
round trip once per K*(d+1) potential tokens. Per iteration, for every
active row:

  1. head CATCH-UP: the previous iteration's emitted (token, feature)
     pairs run through the draft head as a ragged mini-prefill (d+1 query
     rows per sequence; EAGLE3's through the ragged prefill kernel, MTP's
     on MLA's decompressed path), writing verified head-KV entries
     (overwriting last iteration's speculative entries at the same
     positions); the output at the last pending row proposes
     draft token 0;
  2. d-1 more head steps propose the remaining drafts (one query per
     sequence: EAGLE3's through the paged decode kernel, MTP's on MLA's
     absorbed path; speculative head-KV entries);
  3. the TARGET verifies [cur, draft_0..draft_{d-1}] in one pass (d+1
     query rows per sequence: a Llama-family target through the ragged
     prefill kernel in every layer, an MLA target on its decompressed
     path, its latents gathered up to the window's KV bound) and returns
     logits and pre-norm hidden features;
  4. ACCEPTANCE: the longest draft prefix equal to what the target emits
     at each row (greedy: its argmax; sampled: ``rejection_sample``), plus
     one bonus token;
  5. positions advance by accepted+1. Rejected draft KV at positions
     pos+a+1..pos+d is overwritten by the next iteration's verify writes.

Stop ids, min_tokens and max_tokens run on the device as in the multi-step
window; the host trims stop-string overshoot afterwards.

Where the JAX window skips an iteration with no active row
(``lax.cond``), a CUDA graph cannot branch: every iteration runs, with
inactive rows made inert (KV writes to an out-of-range slot, emission
count 0), and ``SpecDeviceState.dead_iters`` counts the iterations the
host can foresee to have no active row. JAX's ``.at[...].set(mode=
"drop")`` scatters become scatters into a trash row S of each state
tensor. The body reads only its static inputs, the state tensors below
and the pools (all updated in place: a graph holds their addresses) and
host ints fixed by its key. The key carries the head's decode-kernel split
count (EAGLE3) or the head's KV bound (MTP, whose MLA gathers up to it),
and for an MLA target the target's KV bound (``graph_bound_key``).

State per sequence slot (device-resident, ``engine.sd``; row S is trash):
  pend_toks  i64[S+1, d+1]     emitted tokens awaiting head catch-up
  pend_feats [S+1, d+1, H]     their target features
  pend_n     i32[S+1]          how many are pending (0 = unseeded)
  pos_h      i32[S+1]          verified head-KV length
  pos_t      i32[S+1]          target write position (device truth: the
                               host's num_device_tokens runs ahead by the
                               unconsumed window budget under overlap)
  emitted_t  i32[S+1]          absolute emitted-token count
Prefill seeds a row via ``spec_seed`` (first sampled token + its feature)
without a host round trip: both operands stay on the device.

A reference fault is ported as it is: the catch-up gives every sequence
d+1 query rows while its KV length is hpos + pn, and attention places row
j at kv_len - (d+1) + j, so pending rows see a history shorter by
(d+1) - pn; where hpos + 2*pn - 1 < d+1 the row that proposes draft 0
sees no key (0 from the kernels here, the mean of V in the JAX
reference). Tokens are unaffected (acceptance is lossless); drafts and
acceptance counts can differ from the JAX package's in those iterations.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from ..ops.attention import AttentionMetadata
from ..ops.sampling_ops import (SamplingTensors, greedy_sample,
                                rejection_sample, top_logprobs)
from ..speculative.one_model import head_step

HEAD_PAGE_SIZE = 32          # the JAX drafter's page size
_LOGPROB_BUCKETS = (1, 5, 8, 20)


def head_pool_bytes(max_batch_size: int, max_seq_len: int, draft_len: int,
                    hidden: int, entry_elems: int, element_size: int) -> int:
    """Device bytes of the head's KV pool (``entry_elems`` a position:
    2 * kv heads * head dim for EAGLE3, the latent width for MTP) and the
    pending features (what ``enable_spec_device`` allocates), for the
    engine to carve out before it sizes the target's KV pool."""
    S = max_batch_size
    pages = -(-max_seq_len // HEAD_PAGE_SIZE)
    pool = S * pages * HEAD_PAGE_SIZE * entry_elems
    feats = (S + 1) * (draft_len + 1) * hidden
    return (pool + feats) * element_size


@dataclasses.dataclass
class SpecDeviceState:
    drafter: Any           # Eagle3Drafter or MtpDrafter
    d: int                 # drafts per iteration
    K: int                 # iterations per window
    ps_h: int              # head KV page size
    P_h: int               # head pages per slot
    kv: torch.Tensor       # head pool [S*P_h, ps_h, *kv_entry_shape]
    pend_toks: torch.Tensor
    pend_feats: torch.Tensor
    pend_n: torch.Tensor
    pos_h: torch.Tensor
    pos_t: torch.Tensor
    emitted_t: torch.Tensor
    # windows dispatched, their iterations, and the iterations the host
    # knew would have no active row (every row done by its budget)
    windows: int = 0
    iters: int = 0
    dead_iters: int = 0


def enable_spec_device(engine, drafter, draft_len: int, K: int) -> None:
    """Attach a one-model draft head to the engine for fused windows.
    The drafter supplies the head function, its parameters and the
    borrowed embedding and lm_head; the engine owns slot-aligned head KV
    sized for max_batch_size."""
    S = engine.max_batch_size
    H = engine.model.hidden_size
    ps = drafter.page_size
    P = -(-engine.max_seq_len // ps)
    dev, dt = engine.device, engine.model.dtype
    i32 = dict(dtype=torch.int32, device=dev)
    engine.sd = SpecDeviceState(
        drafter=drafter, d=draft_len, K=K, ps_h=ps, P_h=P,
        kv=torch.zeros((S * P, ps) + tuple(drafter.kv_entry_shape),
                       dtype=dt, device=dev),
        pend_toks=torch.zeros((S + 1, draft_len + 1), dtype=torch.int64,
                              device=dev),
        pend_feats=torch.zeros((S + 1, draft_len + 1, H), dtype=dt,
                               device=dev),
        pend_n=torch.zeros(S + 1, **i32), pos_h=torch.zeros(S + 1, **i32),
        pos_t=torch.zeros(S + 1, **i32), emitted_t=torch.zeros(S + 1, **i32))


def spec_seed(engine, tokens: torch.Tensor, hidden: torch.Tensor,
              rows: List[int], slots: List[int], positions: List[int],
              emitted: List[int]) -> None:
    """Seed freshly sampled rows: pending = [(token, feature)], head
    history reset, target write position and absolute emitted count set.
    ``tokens`` / ``hidden`` are the prefill step's device outputs by batch
    row; nothing crosses to the host."""
    sd = engine.sd
    dev = engine.device

    def ints(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    r, s = ints(rows), ints(slots)
    sd.pend_toks[s, 0] = tokens[r].long()
    sd.pend_feats[s, 0] = hidden[r].to(sd.pend_feats.dtype)
    sd.pend_n[s] = 1
    sd.pos_h[s] = 0
    sd.pos_t[s] = ints(positions).to(torch.int32)
    sd.emitted_t[s] = ints(emitted).to(torch.int32)


def logprob_width(reqs) -> int:
    """Top-k logprobs a window computes per verify row: 0, or the
    smallest of 1, 5, 8, 20 that covers every row's ask."""
    want = max((r.sampling_params.logprobs or 0) for r in reqs) \
        if reqs else 0
    if want == 0:
        return 0
    return next(k for k in _LOGPROB_BUCKETS if k >= min(want, 20))


def spec_inputs(engine, reqs, Sb: int, greedy: bool) -> Dict[str, Any]:
    """Host inputs of one window over ``reqs`` padded to Sb rows. ints
    i32[4, Sb]: out_slots, budget (the window's emission cap, which bounds
    its KV writes to the pre-allocated pages), absolute max_tokens,
    absolute min_tokens. Padding rows have no slot, so they never run."""
    P, NSTOP = engine.pages_per_seq, engine.NSTOP
    ints = np.zeros((4, Sb), np.int32)
    ints[0] = -1
    seeds = np.zeros(Sb, np.int32)
    stop_ids = np.full((Sb, NSTOP), -1, np.int32)
    page_indices = np.zeros((Sb, P), np.int32)
    for i, r in enumerate(reqs):
        sp = r.sampling_params
        ints[:, i] = (r.seq_slot, r.spec_budget, sp.max_tokens,
                      sp.min_tokens)
        if sp.seed:
            seeds[i] = sp.seed & 0x7FFFFFFF or 1
        ids = list(sp.stop_id_list())[:NSTOP]
        stop_ids[i, :len(ids)] = ids
        blocks = r.kv_block_ids
        page_indices[i, :len(blocks)] = blocks
    inputs = dict(ints=ints, seeds=seeds, stop_ids=stop_ids,
                  page_indices=page_indices)
    if not greedy:
        inputs["samp_ints"], inputs["samp_floats"] = \
            SamplingTensors.rows(reqs, Sb)
    return inputs


def build_spec_window(engine, K: int, Sb: int, greedy: bool = True,
                      seeded: bool = False, num_logprobs: int = 0,
                      head_bound: int = 1, bound: int = 0):
    """The window body for ``GraphRunner``: K unrolled iterations over Sb
    rows. ``head_bound``: the ``max_kv_len`` of the head's passes (the
    decode kernel's hint for EAGLE3's chained steps, MLA's gather for
    MTP's); ``bound``: the target verify's (0: none; an MLA target
    gathers its latents up to it)."""
    sd = engine.sd
    dr = sd.drafter
    d = sd.d
    Dp = d + 1
    S = engine.max_batch_size
    ps, P = engine.page_size, engine.pages_per_seq
    ps_h, P_h = sd.ps_h, sd.P_h
    oob_t = engine.num_kv_pages * ps
    oob_h = S * P_h * ps_h
    H = engine.model.hidden_size
    dev = engine.device

    def body(v):
        out_slots, budget, max_tok, min_tok = v["ints"]
        stops, page_indices = v["stop_ids"], v["page_indices"]
        i32 = dict(dtype=torch.int32, device=dev)
        iota = torch.arange(Sb, device=dev)
        jj = torch.arange(Dp, **i32)
        rowbase = iota * Dp
        cu_q = torch.arange(Sb + 1, **i32) * Dp
        cu_q1 = torch.arange(Sb + 1, **i32)
        num_seqs = torch.full((1,), Sb, **i32)
        all_rows = torch.arange(Sb * Dp, device=dev)
        valid = out_slots >= 0
        slots_c = out_slots.clamp(min=0).long()
        sidx = torch.where(valid, out_slots, S).long()
        hpages = (slots_c[:, None] * P_h
                  + torch.arange(P_h, device=dev)[None]).to(torch.int32)
        st_r = seeds_r = None
        if not greedy:
            st = SamplingTensors.from_rows(v["samp_ints"], v["samp_floats"])
            st_r = SamplingTensors(**{
                f.name: getattr(st, f.name).repeat_interleave(Dp)
                for f in dataclasses.fields(st)})
            if seeded:
                seeds_r = v["seeds"].repeat_interleave(Dp)

        ptoks = sd.pend_toks[slots_c]
        pfeats = sd.pend_feats[slots_c]
        pn = torch.where(valid, sd.pend_n[slots_c], 0)
        hpos = sd.pos_h[slots_c]
        pos = sd.pos_t[slots_c]
        abs_e = sd.emitted_t[slots_c]
        active = valid & (budget > 0) & (pn > 0) & (abs_e < max_tok)
        win = torch.zeros(Sb, **i32)
        last_tok = ptoks[iota, (pn - 1).clamp(min=0).long()]
        outs: List[List[torch.Tensor]] = [[], [], [], [], []]
        for _ in range(K):
            # 1) head catch-up over the pending pairs -> draft 0
            vm = (jj[None] < pn[:, None]) & active[:, None]
            hp = hpos[:, None] + jj
            hp_c = torch.where(vm, hp, (hpos + pn - 1).clamp(min=0)[:, None])
            hpage = hpages.gather(1, (hp // ps_h).clamp(0, P_h - 1).long())
            hslot = torch.where(vm, hpage * ps_h + hp % ps_h, oob_h)
            last_row = rowbase + (pn - 1).clamp(min=0)
            h_all, f_all = head_step(
                dr, pfeats.reshape(Sb * Dp, H), ptoks.reshape(-1), sd.kv,
                AttentionMetadata(
                    kv_lens=torch.where(active, hpos + pn, 1).to(torch.int32),
                    page_indices=hpages, cu_q_lens=cu_q, num_seqs=num_seqs,
                    slot_mapping=hslot.reshape(-1).to(torch.int32),
                    positions=hp_c.reshape(-1), logits_indices=last_row,
                    max_q_len=Dp, max_kv_len=head_bound))
            f = h_all[last_row]
            tok = dr.draft_argmax(f_all[last_row])
            drafts = [tok]
            hbase = hpos + pn     # verified head length after catch-up
            # 2) d-1 chained head steps
            for t in range(d - 1):
                p = hbase + t
                hpg = hpages[iota, (p // ps_h).clamp(0, P_h - 1).long()]
                sm = torch.where(active, hpg * ps_h + p % ps_h, oob_h)
                f, fh = head_step(dr, f, tok, sd.kv, AttentionMetadata(
                    kv_lens=torch.where(active, p + 1, 1).to(torch.int32),
                    page_indices=hpages, cu_q_lens=cu_q1, num_seqs=num_seqs,
                    slot_mapping=sm.to(torch.int32), positions=p,
                    logits_indices=iota, max_q_len=1, max_kv_len=head_bound))
                tok = dr.draft_argmax(fh)
                drafts.append(tok)
            drafts_t = torch.stack(drafts, dim=1)              # [Sb, d]
            # 3) target verify: query rows [cur, drafts...]
            qt = torch.cat([last_tok[:, None], drafts_t], dim=1)
            tp = pos[:, None] + jj
            tpage = page_indices.gather(1, (tp // ps).clamp(0, P - 1).long())
            tslot = torch.where(active[:, None], tpage * ps + tp % ps, oob_t)
            logits, hidden = engine._forward(
                qt.reshape(-1), AttentionMetadata(
                    kv_lens=torch.where(active, pos + Dp, 1).to(torch.int32),
                    page_indices=page_indices, cu_q_lens=cu_q,
                    num_seqs=num_seqs,
                    slot_mapping=tslot.reshape(-1).to(torch.int32),
                    positions=tp.reshape(-1), logits_indices=all_rows,
                    max_q_len=Dp, max_kv_len=bound or None),
                collect_hidden=True)
            lf = logits.float()
            if greedy:
                tgt, lp = greedy_sample(lf)
            else:
                # seeded rows: the position-keyed sample the baseline
                # draws; unseeded rows: true rejection sampling. Row j of
                # a sequence checks draft j (the bonus row has none)
                dflat = torch.cat([drafts_t, torch.full_like(
                    drafts_t[:, :1], -1)], dim=1).reshape(-1)
                pos_r = (pos + 1).repeat_interleave(Dp) + jj.repeat(Sb)
                tgt, lp = rejection_sample(
                    lf, st_r, engine.generator, dflat,
                    row_seeds=None if seeds_r is None else (seeds_r, pos_r))
            tgt = tgt.reshape(Sb, Dp)
            lp = lp.reshape(Sb, Dp)
            if num_logprobs:
                tlv, tli = top_logprobs(lf, num_logprobs)
                outs[3].append(tlv.reshape(Sb, Dp, num_logprobs))
                outs[4].append(tli.reshape(Sb, Dp, num_logprobs))
            # 4) acceptance: longest draft == emitted prefix, plus bonus
            match = (drafts_t == tgt[:, :d]).to(torch.int32)
            c0 = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32) + 1
            hit = (tgt[:, :, None] == stops[:, None, :]).any(-1)
            gate = (abs_e[:, None] + jj + 1) >= min_tok[:, None]
            eff = hit & gate & (jj[None] < c0[:, None])
            has_stop = eff.any(-1)
            first = torch.argmax(eff.to(torch.int32), dim=-1)
            c1 = torch.where(has_stop, first.to(torch.int32) + 1, c0)
            room = torch.minimum((budget - win).clamp(min=0),
                                 (max_tok - abs_e).clamp(min=0))
            c = torch.minimum(c1, room)
            c = torch.where(active, c, 0)
            done = has_stop | ((abs_e + c) >= max_tok) | ((win + c) >= budget)
            emit = jj[None] < c[:, None]
            outs[0].append(torch.where(emit, tgt, -1))
            outs[1].append(torch.where(emit, lp, 0.0))
            outs[2].append(c)
            # 5) pending <- emitted pairs; positions advance by c
            em = active & (c > 0)
            hid = hidden.reshape(Sb, Dp, H).to(pfeats.dtype)
            ptoks = torch.where(em[:, None], tgt, ptoks)
            pfeats = torch.where(em[:, None, None], hid, pfeats)
            pn = torch.where(em, c, pn)
            hpos = torch.where(em, hbase, hpos)
            last_tok = torch.where(
                em, tgt[iota, (c - 1).clamp(min=0).long()], last_tok)
            pos = pos + c
            win = win + c
            abs_e = abs_e + c
            active = active & ~done
        sd.pend_toks[sidx] = ptoks
        sd.pend_feats[sidx] = pfeats
        sd.pend_n[sidx] = pn
        sd.pos_h[sidx] = hpos
        sd.pos_t[sidx] = pos
        sd.emitted_t[sidx] = abs_e
        engine.prev_tokens[sidx] = last_tok
        res = (torch.stack(outs[0]), torch.stack(outs[1]),
               torch.stack(outs[2]), win)
        if num_logprobs:
            res += (torch.stack(outs[3]), torch.stack(outs[4]))
        return res
    return body


def forward_spec_window(engine, batch):
    """Dispatch one fused speculative window for a generation-only batch.
    Rows carry ``spec_budget`` (emission cap, set by the executor after
    KV pre-allocation of budget + d tokens). Returns device tensors:
    tokens [K, Sb, d+1] (-1 past a row's count), logprobs, counts [K, Sb],
    emitted [Sb], then top-k (values, ids) [K, Sb, d+1, k] when a row
    asked for logprobs."""
    sd = engine.sd
    reqs = batch.generation_requests
    n = len(reqs)
    Sb = engine._pick_row_bucket(n)
    engine.iter_counter += 1
    greedy = all(r.sampling_params.greedy for r in reqs)
    seeded = not greedy and any(r.sampling_params.seed for r in reqs)
    k_lp = logprob_width(reqs)
    inputs = spec_inputs(engine, reqs, Sb, greedy)
    budgets = inputs["ints"][1]
    sd.windows += 1
    sd.iters += sd.K
    engine.decode_steps += sd.K
    sd.dead_iters += max(0, sd.K - (int(budgets.max()) if n else 0))
    ndt = max((r.num_device_tokens for r in reqs), default=0)
    reach = ndt + sd.K * (sd.d + 1) + sd.d
    head_bound = engine.head_kv_bound(reach)
    bound = engine._kv_bound(reach)
    return engine.graphs.run(
        engine.spec_key(Sb, greedy, seeded, k_lp, head_bound, bound), inputs,
        build_spec_window(engine, sd.K, Sb, greedy, seeded, k_lp, head_bound,
                          bound),
        inert=lambda: spec_inputs(engine, [], Sb, greedy))
