"""Draft/target two-model speculative decoding (DRAFT_TARGET and PARD).

Port of ``tensorrt_llm_tpu/speculative/model_drafter.py``
(``TwoModelDrafter``; behavioral reference:
tensorrt_llm/_torch/speculative/model_drafter.py:1, a second, smaller
model proposes ``max_draft_len`` tokens per scheduled request and the
target verifies them in one step).

The draft model is one of this package's model classes with its own
paged KV pool on the device, one fixed run of pages per request slot
(slot s owns pages [s*P, (s+1)*P)). Each ``prepare_draft_tokens`` call
runs:

- a catch-up forward over the tokens accepted since the last call,
  packed ragged into one token bucket (``token_buckets``; when the
  catch-ups overflow the largest bucket, the longest ones are dropped and
  their requests run without drafts this step). It runs eagerly, like
  the target's prefill steps: the prefill kernel, or the decode kernel
  when every row feeds one token;
- then K - 1 chained greedy steps, B rows of one query each through the
  decode kernel, replayed from a CUDA graph per (row bucket, the decode
  kernel's split count at the step's KV bound) key. The graph reads the
  catch-up's argmax from a buffer the catch-up writes in place.

With ``parallel_draft`` (PARD, reference: _torch/speculative/pard.py)
the catch-up carries K mask tokens behind each row's history and the
logits at every mask position give all K drafts in that one forward.

Draft-KV consistency: ``kv_len`` freezes at the verified history, so the
drafter never trusts its own proposal; the accepted tokens are fed again
next call and overwrite the proposal's KV in place (KV past ``kv_len`` is
invisible to attention).

Each row attends to its own slot's pages. (The JAX drafter gives row i
the pages of slot i whatever its request's slot, so once a request
finishes and the rows shift, a row drafts from another slot's KV; its
drafts, not its tokens, differ from this one's.)
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.attention import AttentionMetadata
from ..ops.cuda import decode_attention as dec
from ..runtime.cuda_graph import GraphRunner, upload
from ..runtime.model_engine import HostFuture
from ..runtime.request import LlmRequest
from .interface import Drafter


class TwoModelDrafter(Drafter):
    """``model`` / ``params``: the draft model and its weights, on the
    device the drafter runs on."""

    def __init__(self, model, params, *, max_draft_len: int = 4,
                 max_slots: int = 64, page_size: int = 32,
                 max_seq_len: int = 2048,
                 token_buckets: Tuple[int, ...] = (16, 64, 256, 1024),
                 parallel_draft: bool = False, mask_token_id: int = 0):
        super().__init__(max_draft_len)
        self.parallel_draft = parallel_draft
        self.mask_token_id = mask_token_id
        self.model = model
        self.params = params
        self.device = model.device
        self.page_size = page_size
        self.max_seq_len = max_seq_len
        self.max_slots = max_slots
        self.pages_per_slot = -(-max_seq_len // page_size)
        self.kv = model.make_kv_pages(max_slots * self.pages_per_slot,
                                      page_size)
        # rid -> (slot, kv_len = verified tokens resident in draft KV)
        self._state: Dict[int, Tuple[int, int]] = {}
        self._free = list(range(max_slots - 1, -1, -1))
        self.token_buckets = tuple(
            t for t in token_buckets if t <= max_seq_len) or (64,)
        P = self.pages_per_slot
        self._page_indices = np.arange(
            max_slots * P, dtype=np.int32).reshape(max_slots, P)
        # the catch-up's argmax per row, which the chain graph reads
        self._first = torch.zeros(max_slots, dtype=torch.int64,
                                  device=self.device)
        self.graphs = GraphRunner(self.device,
                                  torch.Generator(device=self.device),
                                  capture=self.device.type == "cuda")
        # calls that drafted, catch-up tokens fed, catch-ups dropped by a
        # bucket overflow
        self.calls = 0
        self.catchup_tokens = 0
        self.dropped = 0

    @property
    def device_bytes(self) -> int:
        """Device bytes of the draft model's weights and KV pool."""
        def walk(x):
            if isinstance(x, torch.Tensor):
                yield x
            elif isinstance(x, dict):
                for v in x.values():
                    yield from walk(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    yield from walk(v)
        seen, total = set(), 0
        for t in [self.kv, *walk(self.params)]:
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                total += t.numel() * t.element_size()
        return total

    def _pick_bucket(self, n: int) -> int:
        for b in self.token_buckets:
            if n <= b:
                return b
        return self.token_buckets[-1]

    def _row_bucket(self, n: int) -> int:
        """Rows of a chain graph: a power of two, at most ``max_slots``."""
        return min(1 << (n - 1).bit_length(), self.max_slots)

    def _kv_bound(self, n: int) -> int:
        reach = self.pages_per_slot * self.page_size
        return min(1 << (max(n, 1) - 1).bit_length(), reach)

    def _splits(self, rows: int, bound: int) -> tuple:
        return self.model.graph_bound_key(
            bound, lambda b: self._k1_splits(rows, b))

    def _k1_splits(self, rows: int, bound: int) -> tuple:
        windows = self.model.attention_windows()
        if self.device.type != "cuda":
            return (1,)
        spec = self.model.attn_spec
        reach = self.pages_per_slot * self.page_size
        return tuple(dec.splits_for(rows, spec.num_heads, spec.num_kv_heads,
                                    reach, bound, w, self.device)
                     for w in windows)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def prepare_draft_tokens(self, requests: Sequence[LlmRequest]) -> None:
        ps, K = self.page_size, self.max_draft_len
        work: List[Tuple[LlmRequest, int, List[int]]] = []
        for req in requests:
            req.draft_tokens = []
            hist = req.all_token_ids
            if len(hist) + K + 1 >= self.max_seq_len:
                continue
            st = self._state.get(req.request_id)
            if st is None:
                if not self._free:
                    continue  # no draft slot: run without speculation
                st = (self._free.pop(), 0)
            slot, kv_len = st
            feed = hist[kv_len:]
            if not feed:  # resync guard: re-feed the last token
                kv_len -= 1
                feed = hist[kv_len:]
            if self.parallel_draft:
                feed = list(feed) + [self.mask_token_id] * K
            work.append((req, slot, list(feed)))
            self._state[req.request_id] = (slot, kv_len)
        if not work:
            return
        total = sum(len(w[2]) for w in work)
        T = self._pick_bucket(total)
        while total > T:  # bucket overflow: drop the longest catch-ups
            work.sort(key=lambda w: len(w[2]))
            total -= len(work.pop()[2])
            self.dropped += 1
        if not work:
            return
        self.calls += 1
        self.catchup_tokens += total
        toks = self._propose(work, T)
        for i, (req, slot, _) in enumerate(work):
            # kv_len freezes at the verified history; the proposal's KV
            # beyond it is invisible and overwritten next call
            self._state[req.request_id] = (slot, len(req.all_token_ids))
            req.draft_tokens = [int(x) for x in toks[:, i]]

    def _propose(self, work, T: int) -> np.ndarray:
        """The catch-up (and chain) for ``work``: drafts [K, len(work)]."""
        n, K, ps = len(work), self.max_draft_len, self.page_size
        P = self.pages_per_slot
        oob = self.max_slots * P * ps
        tokens = np.zeros(T, np.int32)
        positions = np.zeros(T, np.int32)
        slot_map = np.full(T, oob, np.int32)
        kv_lens = np.zeros(n, np.int32)
        cu_q = np.zeros(n + 1, np.int32)
        logits_idx = np.zeros(n * K if self.parallel_draft else n, np.int32)
        pages = self._page_indices[[slot for _, slot, _ in work]]
        t = 0
        for i, (req, slot, feed) in enumerate(work):
            # PARD rows: the last K of ``feed`` are mask tokens at
            # positions len(hist)..len(hist)+K-1 (scratch KV, like a
            # chain proposal's)
            m = len(feed)
            start = len(req.all_token_ids) + \
                (K if self.parallel_draft else 0) - m
            pos = np.arange(start, start + m)
            tokens[t:t + m] = feed
            positions[t:t + m] = pos
            slot_map[t:t + m] = pages[i, pos // ps] * ps + pos % ps
            kv_lens[i] = start + m
            if self.parallel_draft:
                logits_idx[i * K:(i + 1) * K] = np.arange(t + m - K, t + m)
            else:
                logits_idx[i] = t + m - 1
            t += m
            cu_q[i + 1] = t
        v = upload(dict(tokens=tokens, positions=positions,
                        slot_mapping=slot_map, kv_lens=kv_lens, cu_q=cu_q,
                        logits_indices=logits_idx, pages=pages,
                        num_seqs=np.asarray([n], np.int32)), self.device)
        lens = np.diff(cu_q)
        md = AttentionMetadata(
            kv_lens=v["kv_lens"], page_indices=v["pages"],
            cu_q_lens=v["cu_q"], num_seqs=v["num_seqs"],
            slot_mapping=v["slot_mapping"], positions=v["positions"],
            logits_indices=v["logits_indices"].long(),
            max_q_len=int(lens.max()), max_kv_len=int(kv_lens.max()))
        logits, _ = self.model.forward(self.params, v["tokens"].long(),
                                       self.kv, md)
        tok = torch.argmax(logits.float(), dim=-1)
        if self.parallel_draft:
            return HostFuture(tok.view(n, K).T).get()[0]
        if K == 1:
            return HostFuture(tok[None]).get()[0]
        self._first[:n].copy_(tok)
        Bb = self._row_bucket(n)
        hist_len = np.zeros(Bb, np.int32)
        hist_len[:n] = [len(req.all_token_ids) for req, _, _ in work]
        bound = self._kv_bound(int(hist_len.max()) + K)
        out = self.graphs.run(
            ("chain", Bb, self._splits(Bb, bound)),
            self._chain_inputs(pages, hist_len, n, Bb),
            self._chain_body(Bb, bound),
            inert=lambda: self._chain_inputs(
                pages[:0], np.zeros(Bb, np.int32), 0, Bb))
        return HostFuture(out[0]).get()[0][:, :n]

    def _chain_inputs(self, pages: np.ndarray, hist_len: np.ndarray,
                      n: int, Bb: int) -> Dict[str, np.ndarray]:
        """The chain's static inputs: rows past ``n`` are inactive."""
        table = np.zeros((Bb, self.pages_per_slot), np.int32)
        table[:n] = pages[:n]
        active = np.zeros(Bb, np.int32)
        active[:n] = 1
        return dict(hist_len=hist_len, active=active, pages=table)

    def _chain_body(self, Bb: int, kv_bound: int):
        """K - 1 chained greedy steps: draft t sits at position
        hist_len + t and its logits give draft t + 1. Inactive rows write
        nowhere (an out-of-range slot) and read one key."""
        ps, P, K = self.page_size, self.pages_per_slot, self.max_draft_len
        oob = self.max_slots * P * ps
        dev = self.device

        def body(v):
            # made inside the body: a captured graph holds these addresses
            iota = torch.arange(Bb, device=dev)
            cu = torch.arange(Bb + 1, dtype=torch.int32, device=dev)
            num_seqs = torch.full((1,), Bb, dtype=torch.int32, device=dev)
            active = v["active"] > 0
            pages, pos0 = v["pages"], v["hist_len"]
            cur = self._first[:Bb]
            toks = [cur.clone()]
            for t in range(K - 1):
                pos = pos0 + t
                col = (pos // ps).clamp(0, P - 1).long()
                md = AttentionMetadata(
                    kv_lens=torch.where(active, pos + 1, 1).to(torch.int32),
                    page_indices=pages, cu_q_lens=cu, num_seqs=num_seqs,
                    slot_mapping=torch.where(
                        active, pages[iota, col] * ps + pos % ps,
                        oob).to(torch.int32),
                    positions=pos, logits_indices=iota, max_q_len=1,
                    max_kv_len=kv_bound)
                logits, _ = self.model.forward(self.params, cur, self.kv, md)
                cur = torch.argmax(logits.float(), dim=-1)
                toks.append(cur)
            return (torch.stack(toks),)
        return body

    def drop_request(self, request_id: int) -> None:
        st = self._state.pop(request_id, None)
        if st is not None:
            self._free.append(st[0])
