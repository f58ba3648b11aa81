"""Beam search on top of the row-request engine.

Port of ``tensorrt_llm_tpu/runtime/beam_search.py`` (``Hypothesis``,
``BeamGroup``, ``make_beam_rows``). Each beam is an ordinary engine row
(its own sequence slot and KV chain); the group re-ranks the candidates
each step from the rows' top-B logprobs and forces the chosen token into
each row through ``host_token_override``. A fork copies the pages where
the source row's chain differs from the destination's, from the page of
the first generated token on, with the engine's page copy.

It runs on the sync scheduler: re-ranking needs step t's logprobs before
step t+1 launches.

Departures from the JAX version, none of which changes a result it
gets right:

- a fork copies every pool's pages (VSWA's sliding pool too, skipping
  the blocks that pool released while the rows run), and a recurrent
  model's slot states (``ModelEngine.copy_slot_states``), where the JAX
  engine's page copy fails on the recurrent families' cache dict;
- all of a step's forks read their source pages before any is written
  (``ModelEngine.copy_pages``). The JAX version copies page by page in
  plan order, so when two rows swap (row 0 continues row 1's beam and row
  1 continues row 0's), the second copy reads a page the first has
  already overwritten, and a beam continues on the other beam's KV;
- the hypotheses returned: when the beams reach ``max_tokens``, every
  live continuation is a finished hypothesis, and a row's own state
  enters only when fewer than ``n`` hypotheses finished, without the
  token its last step sampled, which its score does not hold. The JAX
  version finishes only enough continuations to fill n and then also
  returns each live row's tokens, last sampled token included, with the
  score of the tokens before it: such a hypothesis outranks the correct
  ones and can repeat one of them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from ..sampling_params import SamplingParams
from .request import LlmRequest


@dataclasses.dataclass
class Hypothesis:
    tokens: List[int]
    score: float           # sum of token logprobs

    def final_score(self, length_penalty: float) -> float:
        n = max(len(self.tokens), 1)
        return self.score / (n ** length_penalty)


class BeamGroup:
    def __init__(self, parent: LlmRequest, rows: List[LlmRequest]):
        self.parent = parent
        self.rows = rows
        self.width = len(rows)
        sp = parent.sampling_params
        self.length_penalty = sp.length_penalty
        self.end_id = sp.end_id
        self.max_tokens = sp.max_tokens
        self.n_return = sp.n
        # beam i state: cumulative logprob; -inf = dead slot until grown
        self.scores = [0.0] + [-1e30] * (self.width - 1)
        self.first_step = True
        self.completed: List[Hypothesis] = []
        self.done = False
        self.steps = 0            # the rows' output count last re-ranked
        self.forks = 0            # rows that took another row's beam

    # ------------------------------------------------------------------ #
    def update(self, engine, kv_manager) -> None:
        """Called after each processed step: re-rank, force tokens,
        fork KV."""
        rows = self.rows
        # per-row candidates from the just-recorded top-B logprobs
        candidates: List[Tuple[float, int, int]] = []  # (score, row, tok)
        for i, row in enumerate(rows):
            if self.scores[i] <= -1e29:
                continue
            if not row.logprobs:
                continue
            step_lp = row.logprobs[-1]
            for tok, lp in step_lp.items():
                candidates.append((self.scores[i] + lp, i, tok))
        if not candidates:
            self.done = True
            return
        candidates.sort(reverse=True)
        if self.first_step:
            # all rows shared the same prefill logits; dedup by token
            seen = set()
            uniq = []
            for c in candidates:
                if c[2] not in seen:
                    seen.add(c[2])
                    uniq.append(c)
            candidates = uniq
            self.first_step = False

        # split into finished (EOS) and live continuations
        live: List[Tuple[float, int, int]] = []
        for score, i, tok in candidates:
            if self.end_id is not None and tok == self.end_id:
                hist = rows[i].output_token_ids[:-1]
                self.completed.append(Hypothesis(hist + [tok], score))
            else:
                live.append((score, i, tok))
            if len(live) >= self.width:
                break

        out_len = len(rows[0].output_token_ids)
        if (len(self.completed) >= self.n_return and
                (not live or self._best_possible(live) <=
                 self._worst_completed())):
            self.done = True
        if out_len >= self.max_tokens:
            # every live continuation has the requested length
            for score, i, tok in live:
                self.completed.append(
                    Hypothesis(rows[i].output_token_ids[:-1] + [tok], score))
            self.done = True
        if self.done or not live:
            self.done = True
            return

        # assign the top-`width` live continuations to rows
        plans = [(j, src, tok, score)
                 for j, (score, src, tok) in enumerate(live[:self.width])]
        # snapshot source data before mutation
        src_hist = {src: list(rows[src].output_token_ids)
                    for _, src, _, _ in plans}
        chains = [kv_manager.pool_block_ids(r) for r in rows]
        first_gen_page = rows[0].prompt_len // kv_manager.tokens_per_block
        copies: List[Tuple[List[int], List[int]]] = [
            ([], []) for _ in chains[0]]
        new_scores = [-1e30] * self.width
        for dst, src, tok, score in plans:
            row = rows[dst]
            if src != dst:
                # fork: copy the diverged pages (partial prompt page on)
                self.forks += 1
                for pool, (s_ids, d_ids) in enumerate(copies):
                    sb, db = chains[src][pool], chains[dst][pool]
                    for p in range(first_gen_page, min(len(sb), len(db))):
                        if sb[p] is not None and db[p] is not None \
                                and sb[p] != db[p]:
                            s_ids.append(sb[p])
                            d_ids.append(db[p])
            row.output_token_ids = src_hist[src][:-1] + [tok]
            row.host_token_override = tok
            new_scores[dst] = score
        for pool, (s_ids, d_ids) in enumerate(copies):
            engine.copy_pages(s_ids, d_ids, pool)
        # a recurrent model's rows carry their state in their slots
        forks = [(rows[src].seq_slot, rows[dst].seq_slot)
                 for dst, src, _, _ in plans if src != dst]
        if forks and getattr(engine, "has_recurrent_state", False):
            engine.copy_slot_states([s for s, _ in forks],
                                    [d for _, d in forks])
        self.scores = new_scores

    def _best_possible(self, live) -> float:
        return max(s for s, _, _ in live) / \
            (max(len(self.rows[0].output_token_ids), 1)
             ** self.length_penalty)

    def _worst_completed(self) -> float:
        return min(h.final_score(self.length_penalty)
                   for h in self.completed)

    # ------------------------------------------------------------------ #
    def finalize(self) -> List[Hypothesis]:
        hyps = list(self.completed)
        if len(hyps) < self.n_return:
            # a group that ended early: each live beam so far (its last
            # step's sample is not part of its score)
            for i, row in enumerate(self.rows):
                if self.scores[i] > -1e29:
                    hyps.append(Hypothesis(list(row.output_token_ids[:-1]),
                                           self.scores[i]))
        hyps.sort(key=lambda h: h.final_score(self.length_penalty),
                  reverse=True)
        return hyps[:self.n_return]


def make_beam_rows(parent: LlmRequest) -> List[LlmRequest]:
    """Build the engine row-requests for a beam group."""
    sp = parent.sampling_params
    width = sp.best_of
    rows = []
    for _ in range(width):
        row_sp = SamplingParams(
            max_tokens=sp.max_tokens + 1,  # group terminates before this
            top_k=1, logprobs=width,
            end_id=None, ignore_eos=True)   # EOS handled by the group
        # each beam carries the request's adapter (the JAX rows drop it
        # and decode the base model)
        row = LlmRequest(prompt_token_ids=list(parent.prompt_token_ids),
                         sampling_params=row_sp,
                         cache_salt=parent.cache_salt,
                         lora_task_id=parent.lora_task_id)
        row.is_beam_row = True
        rows.append(row)
    return rows
