"""Device-resident guided decoding: pooled token-DFA segments on the card.

Port of ``tensorrt_llm_tpu/guided/device_guided.py``: the allocator, the
refcounted segments and ``state_after`` unchanged; the pool's tensors
live on the ``ModelEngine`` (``enable_guided``), which writes segment rows
in place (``guided_upload``), since captured CUDA graphs read the pool by
address, and counts them off the KV budget.

Host matchers (grammar_matcher.py) force a host sync per step — the
matcher must observe token t before masking step t+1 — which is exactly
the round-trip the overlap scheduler and the K-step decode window exist
to remove. This module keeps the WHOLE grammar walk on device instead
(reference plays the same trick in-stream with a blocking hostfunc +
kernels/logitsBitmask.cu; here nothing blocks):

  * per-state packed token bitmasks  u8[pool_states, ceil(V/8)]
    (which tokens the grammar admits from each state), applied to the
    logits in the step before sampling;
  * the byte-level DFA table          i16[pool_states, 256]
    used to ADVANCE the state in the step after sampling: the sampled
    token's UTF-8 bytes walk the table inside the step — the
    token-level transition matrix (states x vocab i16, ~64KB/state)
    never needs to exist on device;
  * per-slot grammar state            i32[max_batch + 1] (-1 = unguided;
    the last entry is the trash slot of padding and inactive rows).

Segments are allocated from the pool in 256-state blocks, keyed by the
compiled grammar (MatcherFactory.compile_dfa's cache key) and
REFCOUNTED: concurrent requests with the same schema share one segment,
each with its own scalar state. Guided requests therefore ride the
overlap scheduler and the device-resident multi-step window with zero
per-token host work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..logger import logger
from .grammar_matcher import MatcherFactory, TokenTable
from .token_dfa import build_token_dfa

BLOCK = 256  # pool allocation granularity (states)


@dataclasses.dataclass
class _Segment:
    base: int           # first pool row
    blocks: int         # BLOCK-sized blocks owned
    start: int          # grammar start state (pool-global)
    refs: int = 0


class DeviceGuidedManager:
    """Owns the pool allocator + host-side table builds; the device
    tensors themselves live on the ModelEngine (graphs read them)."""

    def __init__(self, factory: MatcherFactory, table: TokenTable,
                 engine, pool_states: int = 8192):
        self.factory = factory
        self.table = table
        self.engine = engine
        self.pool_states = pool_states
        self._segments: Dict[str, _Segment] = {}
        self._free: List[Tuple[int, int]] = [(0, pool_states)]  # (base, n)
        # wall ms of each segment's build (regex compile unless cached,
        # token DFA, packing, upload), by grammar key
        self.build_ms: Dict[str, float] = {}
        # token byte matrix padded to the MODEL vocab (model vocabs are
        # often padded past the tokenizer's; extra ids are zero-length →
        # never admissible)
        V = engine.model.vocab_size
        tb, tl = table.token_bytes, table.token_lens
        if tb.shape[0] < V:
            tb = np.pad(tb, ((0, V - tb.shape[0]), (0, 0)))
            tl = np.pad(tl, (0, V - tl.shape[0]))
        self.token_bytes = tb[:V]
        self.token_lens = tl[:V]
        engine.enable_guided(self.token_bytes, self.token_lens,
                             table.eos_token_id, pool_states)

    # ------------------------------------------------------------------ #
    # pool allocator
    # ------------------------------------------------------------------ #
    def _alloc(self, blocks: int) -> Optional[int]:
        for i, (base, n) in enumerate(self._free):
            if n >= blocks:
                if n == blocks:
                    self._free.pop(i)
                else:
                    self._free[i] = (base + blocks * BLOCK,
                                     n - blocks * BLOCK)
                return base
        return None

    def _release_span(self, base: int, blocks: int) -> None:
        self._free.append((base, blocks * BLOCK))
        # coalesce
        self._free.sort()
        merged = []
        for b, n in self._free:
            if merged and merged[-1][0] + merged[-1][1] == b:
                merged[-1][1] += n
            else:
                merged.append([b, n])
        self._free = [(b, n) for b, n in merged]

    def _evict_unreferenced(self) -> None:
        for key in [k for k, s in self._segments.items() if s.refs == 0]:
            seg = self._segments.pop(key)
            self._release_span(seg.base, seg.blocks)

    # ------------------------------------------------------------------ #
    def acquire(self, params) -> Optional[int]:
        """Compile (or share) the grammar's segment; returns the pool-
        global START state, or None when the params carry no constraint.
        Raises ValueError when the grammar cannot fit the pool."""
        t0 = time.perf_counter()
        compiled = self.factory.compile_dfa(params)
        if compiled is None:
            return None
        key, dfa = compiled
        seg = self._segments.get(key)
        if seg is None:
            n = dfa.num_states
            blocks = -(-n // BLOCK)
            if blocks * BLOCK > self.pool_states:
                raise ValueError(
                    f"grammar needs {n} DFA states; the device guided "
                    f"pool holds {self.pool_states} (raise "
                    f"TLLM_TPU_GUIDED_POOL_STATES, or build the LLM with "
                    f"guided_decoding_backend='dfa-host' for the host "
                    f"path)")
            base = self._alloc(blocks)
            if base is None:
                self._evict_unreferenced()
                base = self._alloc(blocks)
            if base is None:
                raise NoPoolSpaceError(
                    f"device guided pool exhausted ({n} states wanted)")
            tdfa = build_token_dfa(
                dfa, self.token_bytes, self.token_lens,
                self.table.eos_token_id,
                vocab_size=self.engine.model.vocab_size,
                max_states=self.pool_states)
            pad = blocks * BLOCK
            mask = np.zeros((pad, -(-self.engine.model.vocab_size // 8)),
                            np.uint8)
            mask[:n] = np.packbits(tdfa.trans >= 0, axis=1,
                                   bitorder="little")
            bt = np.full((pad, 256), -1, np.int16)
            bt[:n] = np.where(dfa.table >= 0, dfa.table + base, -1)
            eos = np.zeros((pad,), bool)
            eos[:n] = tdfa.eos_ok
            self.engine.guided_upload(base, bt, mask, eos)
            seg = _Segment(base=base, blocks=blocks,
                           start=base + dfa.start)
            self._segments[key] = seg
            self.build_ms[key] = (time.perf_counter() - t0) * 1e3
            logger.debug("guided segment %s: %d states at pool row %d",
                         key[:40], n, base)
        seg.refs += 1
        return seg.start

    def release(self, params) -> None:
        compiled = self.factory.compile_dfa(params)
        if compiled is None:
            return
        seg = self._segments.get(compiled[0])
        if seg is not None and seg.refs > 0:
            seg.refs -= 1

    @property
    def states_in_use(self) -> int:
        """Pool states held by segments (referenced or cached)."""
        return sum(s.blocks for s in self._segments.values()) * BLOCK

    # ------------------------------------------------------------------ #
    def state_after(self, params, output_tokens: List[int]) -> Optional[int]:
        """Pool-global grammar state after consuming ``output_tokens``
        from the start (used at admission: fresh requests pass [], a
        pause/resume passes the tokens generated before eviction)."""
        compiled = self.factory.compile_dfa(params)
        if compiled is None:
            return None
        key, dfa = compiled
        seg = self._segments[key]
        state = seg.start - seg.base
        eos = self.table.eos_token_id
        for t in output_tokens:
            if t == eos:
                break
            if t >= self.token_lens.shape[0]:
                return -1
            for b in self.token_bytes[t, :self.token_lens[t]]:
                state = int(dfa.table[state, b])
                if state < 0:
                    return -1
        return seg.base + state


class NoPoolSpaceError(RuntimeError):
    """Transient: every pool block is held by a live request."""
