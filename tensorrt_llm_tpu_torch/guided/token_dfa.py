"""Token-level DFA tables for device-resident guided decoding.

Port of ``tensorrt_llm_tpu/guided/token_dfa.py``, unchanged.

The host matchers (grammar_matcher.py) walk a byte-level DFA lazily and
hand the executor a per-step logits bitmask — which forces a host sync
between steps (the reference pays the same price via a stream-blocking
hostfunc, guided_decoder.py:140 + kernels/logitsBitmask.cu). The
device path instead collapses the byte DFA into a TOKEN-level transition table once
at request admission:

    trans[s, v] = DFA state after consuming token v's bytes from s
                  (-1 = the token is not allowed in state s)
    eos_ok[s]   = EOS permitted in state s (accepting, or dead-end valve)

and upload it into a pooled device array. The step then masks
logits with ``trans[state] >= 0`` and advances ``state = trans[state,
tok]`` entirely in-graph — guided requests ride the overlap scheduler
and the K-step device-resident decode window with zero host round-trips.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .regex_dfa import DEAD, DFA


@dataclasses.dataclass
class TokenDFA:
    trans: np.ndarray      # i16[nstates, V]; -1 = disallowed
    eos_ok: np.ndarray     # bool[nstates]
    start: int

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]


def build_token_dfa(dfa: DFA, token_bytes: np.ndarray,
                    token_lens: np.ndarray, eos_token_id: int,
                    vocab_size: Optional[int] = None,
                    max_states: int = 32000,
                    state_block: int = 256) -> Optional[TokenDFA]:
    """Collapse a byte DFA into a token-level transition table.

    Vectorized over (state-block, vocab); semantics identical to
    TokenMaskCache.final_states / mask / fill_next_token_bitmask:
    a token is allowed iff its byte walk never dies AND it is non-empty;
    EOS is allowed in accepting states and as the dead-end safety valve.
    Returns None when the DFA exceeds ``max_states`` (int16 pool ids) —
    callers fall back to the host-sync bitmask path.
    """
    n = dfa.num_states
    if n > max_states:
        return None
    V, L = token_bytes.shape
    Vout = vocab_size or V
    table = dfa.table
    trans = np.full((n, Vout), DEAD, np.int16)
    for s0 in range(0, n, state_block):
        s1 = min(n, s0 + state_block)
        cur = np.broadcast_to(
            np.arange(s0, s1, dtype=np.int32)[:, None], (s1 - s0, V)).copy()
        for j in range(L):
            active = (token_lens > j)[None, :]             # [1, V]
            alive = (cur >= 0) & active
            nxt = np.where(alive,
                           table[np.clip(cur, 0, None),
                                 token_bytes[None, :, j]], cur)
            cur = np.where(active, np.where(cur >= 0, nxt, DEAD), cur)
        cur[:, token_lens == 0] = DEAD                     # empty tokens
        trans[s0:s1, :V] = cur.astype(np.int16)
    # EOS column: never a grammar transition — its admissibility is the
    # per-state eos_ok bit, applied separately in-graph
    if 0 <= eos_token_id < Vout:
        trans[:, eos_token_id] = DEAD
    any_allowed = (trans >= 0).any(axis=1)
    eos_ok = dfa.accepting | ~any_allowed
    return TokenDFA(trans=trans, eos_ok=eos_ok, start=dfa.start)
