"""Model engine: owns params + the KV pool and drives each step.

Port of ``tensorrt_llm_tpu/runtime/model_engine.py`` (``StepInputs``,
``prepare_inputs``, ``forward_step``, the K-step decode window of
``_build_multi_step`` / ``forward_multi_step``, token buckets and KV-pool
sizing) without guided decoding, LoRA, speculation, tree drafts, VSWA,
M-RoPE, MoE statistics, pipeline parallelism and mixed rider windows.

Execution is eager. Each step's ragged batch is still padded to a token
bucket, so that a later CUDA graph per bucket can replay it. Sampled
tokens stay on the device, scattered by sequence slot into
``prev_tokens``; the next step gathers its decode inputs from there, so
the overlap scheduler (executor.py) never waits for a token on the host.
Host inputs go up in one pinned, non-blocking copy per step and results
come back the same way (``HostFuture``): the host only synchronizes when
it reads a result.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..llmapi.llm_args import LlmArgs
from ..logger import logger
from ..models.modeling_utils import DecoderModelForCausalLM
from ..ops.attention import AttentionMetadata
from ..ops.sampling_ops import (SamplingTensors, greedy_sample, sample,
                                top_logprobs)
from .scheduler import ScheduledRequests


@dataclasses.dataclass
class StepInputs:
    """Host-built (numpy) inputs for one iteration, pre-padding."""
    token_ids: np.ndarray          # i32[T] host-known tokens (0 where device-sourced)
    prev_slot: np.ndarray          # i32[T] slot to gather prev token from, -1=host
    positions: np.ndarray          # i32[T]
    kv_lens: np.ndarray            # i32[S]
    page_indices: np.ndarray       # i32[S, P]
    cu_q_lens: np.ndarray          # i32[S+1]
    num_seqs: np.ndarray           # i32[1]
    slot_mapping: np.ndarray       # i32[T]
    logits_indices: np.ndarray     # i32[S]
    out_slots: np.ndarray          # i32[S] slot to scatter sampled token to (-1 pad)
    num_tokens: int                # actual (unpadded) token count
    num_reqs: int
    max_q_len: int                 # longest query segment (1 = decode-only)
    max_kv_len: int                # longest KV length incl. this step


class HostFuture:
    """Device tensors on their way to the host: a non-blocking copy into
    pinned memory plus an event, started at dispatch. ``get`` waits for
    the event only (CPU tensors are ready at once)."""

    def __init__(self, *tensors: torch.Tensor):
        self._event = None
        if tensors and tensors[0].device.type == "cuda":
            self._host = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True) for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = list(tensors)

    def get(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


class ModelEngine:
    NSTOP = 8  # stop-token ids checked on the device per row

    def __init__(self,
                 model: DecoderModelForCausalLM,
                 params: Dict[str, Any],
                 args: LlmArgs,
                 num_kv_pages: Optional[int] = None):
        self.model = model
        self.args = args
        self.device = model.device
        self.max_batch_size = args.max_batch_size
        self.page_size = args.kv_cache_config.tokens_per_block
        self.max_seq_len = args.max_seq_len
        self.pages_per_seq = -(-self.max_seq_len // self.page_size)
        self.token_buckets = args.bucketing_config.resolve_token_buckets(
            args.max_num_tokens)
        # a decode-only full batch is the hottest shape: give it an exact
        # bucket so it never pads to the next power
        decode_bucket = min(self.max_batch_size, args.max_num_tokens)
        self.token_buckets = sorted(set(self.token_buckets) |
                                    {decode_bucket})
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        self.iter_counter = 0
        self.params = params
        self.num_kv_pages = num_kv_pages or self._default_num_pages()
        logger.info("KV pool: %d pages x %d tokens (%.1f MB/layer)",
                    self.num_kv_pages, self.page_size,
                    self._kv_bytes_per_layer() / 1e6)
        self.kv_pages = model.make_kv_pages(self.num_kv_pages,
                                            self.page_size)
        # slot-indexed device state; index max_batch_size is a trash slot
        # that absorbs the scatters of padding and inactive rows
        self.prev_tokens = torch.zeros(self.max_batch_size + 1,
                                       dtype=torch.int64, device=self.device)
        self.token_counts: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------ #
    # Sizing
    # ------------------------------------------------------------------ #
    @property
    def bytes_per_kv_block(self) -> int:
        el = torch.empty((), dtype=self.model.config.kv_cache_dtype) \
            .element_size()
        return (self.model.num_layers * self.page_size *
                2 * self.model.num_kv_heads * self.model.head_dim * el)

    def _kv_bytes_per_layer(self) -> int:
        return self.num_kv_pages * self.bytes_per_kv_block \
            // self.model.num_layers

    def _default_num_pages(self) -> int:
        """KV pool sizing from free device memory (a fixed 2 GiB budget
        on the CPU)."""
        cfg = self.args.kv_cache_config
        if cfg.max_tokens is not None:
            return -(-cfg.max_tokens // self.page_size)
        bytes_per_page = self.bytes_per_kv_block
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            budget = int(free * cfg.free_gpu_memory_fraction) - (1 << 30)
        else:
            budget = 2 << 30
        budget = max(budget, bytes_per_page * self.max_batch_size)
        pages = budget // bytes_per_page
        # at least one page per sequence; at most every sequence in full
        pages = min(pages, self.max_batch_size * self.pages_per_seq + 1)
        return int(max(pages, self.max_batch_size + 1))

    def _pick_bucket(self, n: int) -> int:
        for b in self.token_buckets:
            if n <= b:
                return b
        raise ValueError(f"{n} tokens exceeds max bucket "
                         f"{self.token_buckets[-1]}")

    @functools.cached_property
    def row_buckets(self) -> List[int]:
        S = self.max_batch_size
        return sorted({b for b in self.token_buckets if b < S} | {S})

    def _pick_row_bucket(self, n: int) -> int:
        for b in self.row_buckets:
            if n <= b:
                return b
        raise ValueError(f"{n} rows exceeds max_batch_size")

    # ------------------------------------------------------------------ #
    # Host -> device
    # ------------------------------------------------------------------ #
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """One host array to the device without blocking the host."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _counts(self, use_penalties: bool) -> Optional[torch.Tensor]:
        if use_penalties and self.token_counts is None:
            self.token_counts = torch.zeros(
                (self.max_batch_size + 1, self.model.vocab_size),
                dtype=torch.int32, device=self.device)
        return self.token_counts if use_penalties else None

    def reset_slot_counts(self, slots: List[int]) -> None:
        """Zero the penalty counts of newly admitted slots so a recycled
        slot can't leak the previous request's token history."""
        if self.token_counts is None or not slots:
            return
        self.token_counts[torch.as_tensor(slots, device=self.device)] = 0

    # ------------------------------------------------------------------ #
    # Input preparation (host, numpy)
    # ------------------------------------------------------------------ #
    def prepare_inputs(self, batch: ScheduledRequests) -> StepInputs:
        """Flatten the scheduled batch into ragged arrays."""
        S, P, ps = self.max_batch_size, self.pages_per_seq, self.page_size
        reqs = batch.context_requests + batch.generation_requests
        if len(reqs) > S:
            raise ValueError(f"{len(reqs)} > max_batch_size {S}")
        tok_list: List[int] = []
        prev_list: List[int] = []
        pos_list: List[int] = []
        slot_map: List[int] = []
        kv_lens = np.zeros(S, np.int32)
        page_indices = np.zeros((S, P), np.int32)
        cu_q = np.zeros(S + 1, np.int32)
        logits_idx = np.zeros(S, np.int32)
        out_slots = np.full(S, -1, np.int32)
        max_q = 0
        for i, req in enumerate(reqs):
            blocks = req.kv_block_ids
            page_indices[i, :len(blocks)] = blocks
            last_chunk_row = True
            if req.is_context_init_state:
                start = req.context_current_position
                end = min(req.context_len, start + req.context_chunk_size)
                last_chunk_row = end >= req.context_len
                tok_list.extend(req.context_token_ids[start:end])
                prev_list.extend([-1] * (end - start))
                pos_list.extend(range(start, end))
                slot_map.extend(blocks[p // ps] * ps + p % ps
                                for p in range(start, end))
                kv_lens[i] = end
                max_q = max(max_q, end - start)
            else:
                # generation: the input token comes from prev_tokens[slot]
                # (device, overlap mode) or the host (sync mode)
                pos = req.num_device_tokens
                if req.host_token_override is not None:
                    tok_list.append(req.host_token_override)
                    prev_list.append(-1)
                else:
                    tok_list.append(0)
                    prev_list.append(req.seq_slot)
                pos_list.append(pos)
                slot_map.append(blocks[pos // ps] * ps + pos % ps)
                kv_lens[i] = pos + 1
                max_q = max(max_q, 1)
            logits_idx[i] = len(tok_list) - 1
            cu_q[i + 1] = len(tok_list)
            # mid-chunk context rows produce no real sample: route their
            # scatter to the trash slot so junk tokens can't pollute
            # prev_tokens / token_counts for the slot
            out_slots[i] = req.seq_slot if last_chunk_row else -1
        cu_q[len(reqs) + 1:] = len(tok_list)
        return StepInputs(
            token_ids=np.asarray(tok_list, np.int32),
            prev_slot=np.asarray(prev_list, np.int32),
            positions=np.asarray(pos_list, np.int32),
            kv_lens=kv_lens, page_indices=page_indices, cu_q_lens=cu_q,
            num_seqs=np.asarray([len(reqs)], np.int32),
            slot_mapping=np.asarray(slot_map, np.int32),
            logits_indices=logits_idx, out_slots=out_slots,
            num_tokens=len(tok_list), num_reqs=len(reqs), max_q_len=max_q,
            max_kv_len=int(kv_lens.max()))

    # ------------------------------------------------------------------ #
    # Forward + sample for one scheduled batch
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def forward_step(self, batch: ScheduledRequests,
                     use_penalties: bool = False):
        """Launch one iteration. Returns (tokens, logprobs, top_lp) as
        device tensors indexed by batch row; top_lp is (values, ids) when
        a request asked for logprobs, else None."""
        inp = self.prepare_inputs(batch)
        T = self._pick_bucket(inp.num_tokens)
        n = inp.num_tokens
        S = self.max_batch_size
        num_slots = self.num_kv_pages * self.page_size
        self.iter_counter += 1
        reqs = batch.context_requests + batch.generation_requests

        ints_t = np.zeros((4, T), np.int32)
        ints_t[0, :n] = inp.token_ids
        ints_t[1, :] = -1
        ints_t[1, :n] = inp.prev_slot
        ints_t[2, :n] = inp.positions
        # padding tokens write to an out-of-range slot -> dropped
        ints_t[3, :] = num_slots
        ints_t[3, :n] = inp.slot_mapping
        seeds = np.zeros(S, np.int32)
        for i, r in enumerate(reqs):
            if r.sampling_params.seed:
                seeds[i] = r.sampling_params.seed & 0x7FFFFFFF or 1
        ints_s = np.concatenate([inp.kv_lens, inp.cu_q_lens,
                                 inp.logits_indices, inp.out_slots,
                                 inp.num_seqs, seeds])
        dev_t = self._upload(ints_t)
        dev_s = self._upload(ints_s)
        pages = self._upload(inp.page_indices)
        o = 0
        kv_lens = dev_s[o:o + S]; o += S
        cu_q = dev_s[o:o + S + 1]; o += S + 1
        logits_idx = dev_s[o:o + S]; o += S
        out_slots = dev_s[o:o + S]; o += S
        num_seqs = dev_s[o:o + 1]; o += 1
        row_seeds = dev_s[o:o + S]

        prev_slot = dev_t[1].long()
        tokens_in = torch.where(prev_slot >= 0,
                                self.prev_tokens[prev_slot.clamp(min=0)],
                                dev_t[0].long())
        metadata = AttentionMetadata(
            kv_lens=kv_lens, page_indices=pages, cu_q_lens=cu_q,
            num_seqs=num_seqs, slot_mapping=dev_t[3], positions=dev_t[2],
            logits_indices=logits_idx.long(), max_q_len=inp.max_q_len,
            max_kv_len=inp.max_kv_len)
        logits, self.kv_pages = self.model.forward(
            self.params, tokens_in, self.kv_pages, metadata)

        all_greedy = all(r.sampling_params.greedy for r in reqs)
        counts = self._counts(use_penalties)
        slot_idx = torch.where(out_slots >= 0, out_slots, S).long()
        if all_greedy and not use_penalties:
            new_tokens, logprobs = greedy_sample(logits)
        else:
            st = SamplingTensors.from_requests(reqs, S, self.device)
            new_tokens, logprobs = sample(
                logits, st, self.generator,
                token_counts=counts[slot_idx] if use_penalties else None,
                row_seeds=(row_seeds, kv_lens) if seeds.any() else None)
        # scatter by slot for the next iteration's gather; padding rows
        # land in the trash slot
        self.prev_tokens[slot_idx] = new_tokens
        if use_penalties:
            counts.index_put_((slot_idx, new_tokens),
                              torch.ones_like(new_tokens, dtype=counts.dtype),
                              accumulate=True)
        want_lp = max((r.sampling_params.logprobs or 0) for r in reqs) \
            if reqs else 0
        top_lp = top_logprobs(logits, min(want_lp, 20)) if want_lp else None
        return new_tokens, logprobs, top_lp

    # ------------------------------------------------------------------ #
    # K-step decode window: K decode iterations dispatched back to back
    # with the sampled tokens kept on the device, per-row stop handling
    # (stop ids / min_tokens / token budget) on the device, and one host
    # fetch per window.
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def forward_multi_step(self, batch: ScheduledRequests, K: int,
                           use_penalties: bool = False):
        """Launch one K-step decode window for a generation-only batch.
        Each request must carry ``multi_step_budget`` (set by the executor
        after KV pre-allocation). Returns device tensors (tokens [K', Sb],
        logprobs [K', Sb], emitted [Sb]) with K' = the largest budget."""
        reqs = batch.generation_requests
        n = len(reqs)
        Sb = self._pick_row_bucket(n)
        ps, P = self.page_size, self.pages_per_seq
        NSTOP = self.NSTOP
        self.iter_counter += 1

        # ints rows: token_ids, prev_slot, start_pos, out_slots, max_new,
        # stop_gate, row_seeds
        ints = np.zeros((7, Sb), np.int32)
        ints[1] = -1
        ints[3] = -1
        stop_ids = np.full((Sb, NSTOP), -1, np.int32)
        page_indices = np.zeros((Sb, P), np.int32)
        for i, r in enumerate(reqs):
            sp = r.sampling_params
            ndt = r.num_device_tokens
            if r.host_token_override is not None:
                ints[0, i] = r.host_token_override
            else:
                ints[1, i] = r.seq_slot
            ints[2, i] = ndt
            ints[3, i] = r.seq_slot
            ints[4, i] = r.multi_step_budget
            ints[5, i] = max(0, sp.min_tokens - (ndt - r.prompt_len))
            if sp.seed:
                ints[6, i] = sp.seed & 0x7FFFFFFF or 1
            ids = list(sp.stop_id_list())[:NSTOP]
            stop_ids[i, :len(ids)] = ids
            blocks = r.kv_block_ids
            page_indices[i, :len(blocks)] = blocks
        K = max(1, min(K, int(ints[4].max()) if n else 1))
        dev = self._upload(np.concatenate([ints, stop_ids.T], axis=0))
        pages = self._upload(page_indices)
        token_ids, prev_slot, start_pos, out_slots, max_new, stop_gate, \
            row_seeds = dev[:7]
        stops = dev[7:].T                                    # [Sb, NSTOP]
        all_greedy = all(r.sampling_params.greedy for r in reqs)
        seeded = bool(ints[6].any())
        st = None if all_greedy and not use_penalties else \
            SamplingTensors.from_requests(reqs, Sb, self.device)
        counts = self._counts(use_penalties)

        num_slots_oob = self.num_kv_pages * ps
        nslots = self.max_batch_size
        valid = out_slots >= 0
        iota = torch.arange(Sb, device=self.device)
        cu_q = torch.arange(Sb + 1, dtype=torch.int32, device=self.device)
        num_seqs = torch.full((1,), Sb, dtype=torch.int32,
                              device=self.device)
        prev = prev_slot.long()
        cur = torch.where(prev >= 0, self.prev_tokens[prev.clamp(min=0)],
                          token_ids.long())
        pos = start_pos
        active = valid & (max_new > 0)
        emitted = torch.zeros(Sb, dtype=torch.int32, device=self.device)
        toks, lps = [], []
        # host-known bound of every row's kv_len at step k of the window:
        # a row advances by at most one position per step
        max_start = int(ints[2].max()) if n else 0
        for step in range(K):
            kv_len = torch.where(valid, pos + 1, 1).to(torch.int32)
            page_row = pages[iota, (pos // ps).clamp(0, P - 1).long()]
            slot_map = torch.where(active, page_row * ps + pos % ps,
                                   num_slots_oob).to(torch.int32)
            metadata = AttentionMetadata(
                kv_lens=kv_len, page_indices=pages, cu_q_lens=cu_q,
                num_seqs=num_seqs, slot_mapping=slot_map,
                positions=pos, logits_indices=iota, max_q_len=1,
                max_kv_len=max_start + step + 1)
            logits, self.kv_pages = self.model.forward(
                self.params, cur, self.kv_pages, metadata)
            slot_idx = torch.where(active, out_slots, nslots).long()
            if st is None:
                tok, lp = greedy_sample(logits)
            else:
                tok, lp = sample(
                    logits, st, self.generator,
                    token_counts=counts[slot_idx] if use_penalties else None,
                    row_seeds=(row_seeds, kv_len) if seeded else None)
            new_emitted = emitted + active.to(torch.int32)
            hit_stop = (tok[:, None] == stops).any(dim=1)
            stopped = hit_stop & (new_emitted >= stop_gate)
            len_done = new_emitted >= max_new
            self.prev_tokens[slot_idx] = tok
            if use_penalties:
                counts.index_put_((slot_idx, tok),
                                  torch.ones_like(tok, dtype=counts.dtype),
                                  accumulate=True)
            pos = pos + active.to(pos.dtype)
            active = active & ~stopped & ~len_done
            emitted = new_emitted
            cur = tok
            toks.append(tok)
            lps.append(lp)
        return torch.stack(toks), torch.stack(lps), emitted

