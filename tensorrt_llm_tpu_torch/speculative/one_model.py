"""The host-orchestrated path of the one-model drafters (EAGLE3, MTP).

Port of the proposal functions the JAX ``Eagle3Drafter`` and
``MtpDrafter`` share (speculative/eagle.py:188-284 and :442-555,
speculative/mtp.py:164-307), for ``SpeculativeConfig(device_window=
False)``: the executor runs on the sync scheduler, streams every emitted
token's (token, pre-norm target feature) pair into
``LlmRequest.eagle_feats``, and before each step ``prepare_draft_tokens``
runs, over the requests' pending pairs padded to a token bucket:

  1. one catch-up pass of the head over the pending pairs (a ragged
     prefill, writing the verified entries of the head's own paged pool);
     the output at each request's last pending row proposes draft 0;
  2. K-1 chained head steps (one query a request) propose the rest.

The head's pool holds ``max_slots`` page runs of ``pages_per_slot``
pages; a request takes a slot at its first proposal and gives it back
in ``drop_request``. Requests with no pending pair, too close to
``max_seq_len``, or without a free slot get no drafts; when the pending
pairs exceed the largest bucket, the requests with the most are left for
a later call.

One difference from the JAX drafters, which attend each work row i over
the page run of slot i while writing the run of the request's own slot:
here row i reads its request's slot, so a request whose slot is not its
row index (a slot given back and taken again, a request without pending
pairs in between) attends its own history. Drafts differ from the JAX
package's there; tokens do not (acceptance is lossless).

Runs eagerly (no CUDA graph): the host path is the sync scheduler's, one
proposal a step.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.attention import AttentionMetadata
from ..ops.linear import dot_f32
from ..runtime.request import LlmRequest
from .interface import Drafter


def head_step(drafter, feats: torch.Tensor, tok_ids: torch.Tensor,
              kv: torch.Tensor, md: AttentionMetadata
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two head signatures normalised (the JAX spec_window.py:89-97):
    (the feature that feeds the next chained step, the one the lm_head
    reads). EAGLE3's ``head_forward`` returns one tensor for both, MTP's
    (raw hidden, head-normed hidden)."""
    out = drafter.head_forward(feats, tok_ids, kv, md)
    return out if isinstance(out, tuple) else (out, out)


class OneModelDrafter(Drafter):
    """Shared state and proposal of a one-model head. Subclasses set
    ``H``, ``dtype``, ``device``, ``embed``, ``lm_head`` and
    ``kv_entry_shape`` and give ``head_forward``, then call
    ``_init_host``."""
    wants_hidden_states = True

    def _init_host(self, max_slots: int, page_size: int, max_seq_len: int,
                   token_buckets: Sequence[int]) -> None:
        """The host path's pool and slots; ``max_slots`` 0 (the fused
        window, whose pool the engine owns) allocates none."""
        self.page_size = page_size
        self.max_seq_len = max_seq_len
        self.max_slots = max_slots
        self.pages_per_slot = -(-max_seq_len // page_size)
        self.token_buckets = tuple(t for t in token_buckets
                                   if t <= max_seq_len) or (64,)
        P = self.pages_per_slot
        self._page_indices = np.arange(max_slots * P,
                                       dtype=np.int32).reshape(max_slots, P)
        self._state: Dict[int, Tuple[int, int]] = {}  # rid -> (slot, pos)
        self._free = list(range(max_slots - 1, -1, -1))
        self.kv = torch.zeros((max_slots * P, page_size)
                              + tuple(self.kv_entry_shape),
                              dtype=self.dtype, device=self.device) \
            if max_slots else None
        self.acceptance_window: List[int] = []
        # every step since build: drafts accepted, steps
        self.accepted_total = 0
        self.steps_total = 0

    def draft_argmax(self, f: torch.Tensor) -> torch.Tensor:
        """The draft token of each feature row: argmax of ``f @ lm_head``
        taken in float32."""
        return torch.argmax(dot_f32(f, self.lm_head["weight"]), dim=-1)

    def _pick_bucket(self, n: int) -> int:
        for b in self.token_buckets:
            if n <= b:
                return b
        return self.token_buckets[-1]

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def prepare_draft_tokens(self, requests: Sequence[LlmRequest]) -> None:
        K = self.max_draft_len
        work = []
        for req in requests:
            req.draft_tokens = []
            feats = req.eagle_feats
            if not feats:
                continue
            if len(req.all_token_ids) + K + 1 >= self.max_seq_len:
                continue
            st = self._state.get(req.request_id)
            if st is None:
                if not self._free:
                    continue
                st = (self._free.pop(), 0)
                self._state[req.request_id] = st
            work.append((req, st[0], st[1], list(feats)))
        if not work:
            return
        total = sum(len(w[3]) for w in work)
        T = self._pick_bucket(total)
        while total > T:
            work.sort(key=lambda w: len(w[3]))
            total -= len(work.pop()[3])

        B, ps, P = self.max_slots, self.page_size, self.pages_per_slot
        feats_arr = np.zeros((T, self.H), np.float32)
        tok_ids = np.zeros(T, np.int64)
        positions = np.zeros(T, np.int32)
        slot_map = np.full(T, B * P * ps, np.int32)
        pages = np.zeros((B, P), np.int32)
        kv_lens = np.ones(B, np.int32)
        cu_q = np.zeros(B + 1, np.int32)
        logits_idx = np.zeros(B, np.int64)
        next_pos = np.zeros(B, np.int32)
        active = np.zeros(B, bool)
        t = 0
        for i, (req, slot, pos0, feats) in enumerate(work):
            n = len(feats)
            pages[i] = self._page_indices[slot]
            for j, (tok, f) in enumerate(feats):
                feats_arr[t + j] = f
                tok_ids[t + j] = tok
                p = pos0 + j
                positions[t + j] = p
                slot_map[t + j] = pages[i, p // ps] * ps + p % ps
            kv_lens[i] = pos0 + n
            logits_idx[i] = t + n - 1
            next_pos[i] = pos0 + n
            active[i] = True
            t += n
        lens = [len(w[3]) for w in work]
        cu_q[1:len(work) + 1] = np.cumsum(lens)
        cu_q[len(work) + 1:] = cu_q[len(work)]
        reach = P * ps
        bound = min(reach, 1 << (int(next_pos.max()) + K - 1).bit_length())
        toks = self._propose(
            {k: torch.as_tensor(v).to(self.device) for k, v in dict(
                feats=feats_arr, tok_ids=tok_ids, positions=positions,
                slot_map=slot_map, pages=pages, kv_lens=kv_lens, cu_q=cu_q,
                logits_idx=logits_idx, next_pos=next_pos,
                active=active).items()},
            max(lens), bound).cpu().numpy()
        for i, (req, slot, pos0, feats) in enumerate(work):
            # verified features are resident up to pos0 + n; the chain's
            # entries beyond are scratch, overwritten by the next catch-up
            self._state[req.request_id] = (slot, pos0 + len(feats))
            req.eagle_feats = req.eagle_feats[len(feats):]
            req.draft_tokens = [int(x) for x in toks[:, i]]

    def _propose(self, v: Dict[str, torch.Tensor], max_q: int,
                 bound: int) -> torch.Tensor:
        """Catch-up, then K-1 chained steps: drafts [K, B] on the
        device."""
        B, ps, P = self.max_slots, self.page_size, self.pages_per_slot
        dev = self.device
        i32 = dict(dtype=torch.int32, device=dev)
        num_seqs = torch.full((1,), B, **i32)
        iota = torch.arange(B, device=dev)
        pages = v["pages"]
        h, f = head_step(self, v["feats"], v["tok_ids"], self.kv,
                         AttentionMetadata(
                             kv_lens=v["kv_lens"], page_indices=pages,
                             cu_q_lens=v["cu_q"], num_seqs=num_seqs,
                             slot_mapping=v["slot_map"],
                             positions=v["positions"],
                             logits_indices=v["logits_idx"],
                             max_q_len=max_q, max_kv_len=bound))
        h = h[v["logits_idx"]]
        tok = self.draft_argmax(f[v["logits_idx"]])
        drafts = [tok]
        active, next_pos = v["active"], v["next_pos"]
        oob = B * P * ps
        for t in range(self.max_draft_len - 1):
            pos = next_pos + t
            pg = pages[iota, (pos // ps).clamp(0, P - 1).long()]
            sm = torch.where(active, pg * ps + pos % ps, oob)
            h, f = head_step(self, h, tok, self.kv, AttentionMetadata(
                kv_lens=torch.where(active, pos + 1, 1).to(torch.int32),
                page_indices=pages,
                cu_q_lens=torch.arange(B + 1, **i32), num_seqs=num_seqs,
                slot_mapping=sm.to(torch.int32), positions=pos,
                logits_indices=iota, max_q_len=1, max_kv_len=bound))
            tok = self.draft_argmax(f)
            drafts.append(tok)
        return torch.stack(drafts)

    # ------------------------------------------------------------------ #
    def update(self, request: LlmRequest, accepted: List[int]) -> None:
        self.acceptance_window.append(len(accepted))
        if len(self.acceptance_window) > 512:
            self.acceptance_window.pop(0)
        self.accepted_total += len(accepted)
        self.steps_total += 1

    def drop_request(self, request_id: int) -> None:
        st = self._state.pop(request_id, None)
        if st is not None:
            self._free.append(st[0])
