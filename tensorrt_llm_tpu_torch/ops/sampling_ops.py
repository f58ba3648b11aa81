"""Batched on-device sampling.

Port of ``tensorrt_llm_tpu/ops/sampling_ops.py`` (``SamplingTensors``,
``apply_penalties``, ``mask_logits``, ``sample``, ``rejection_sample``,
``top_logprobs``; ``NGRAM_MAX`` and ``ngram_ban_mask``; the embedding
bias and the bad-word ban of the JAX engine's step, ``add_embedding_bias``
and ``ban_token_ids``). One
vectorized routine serves the whole batch with per-row parameters: the
masking is one [B, V] sort, the draw a Gumbel argmax, and greedy rows take
the plain argmax (bit-exact with the JAX version for equal logits).

Random numbers cannot match ``jax.random`` bit for bit, so draws are held
to the JAX version by distribution. Unseeded rows draw from the caller's
``torch.Generator``. Rows with ``SamplingParams.seed`` draw from a counter
hash of (seed, position, vocab id) computed with integer tensor ops on the
device, so a seeded request's stream is a function of its seed and
position only — independent of batch composition, as in the JAX version —
and needs no host sync inside a decode window. Nothing here syncs with the
host or copies from it, so a CUDA graph can capture ``sample`` and
``greedy_sample``; the per-row controls reach the device packed
(``SamplingTensors.rows`` / ``from_rows``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class SamplingTensors:
    """Per-row sampling controls, padded to the batch bucket.

    top_k == 0 disables top-k; top_p == 1 disables top-p; greedy rows use
    pure argmax (temperature == 0 semantics of SamplingParams)."""
    temperature: torch.Tensor        # f32[B]
    top_k: torch.Tensor              # i64[B]
    top_p: torch.Tensor              # f32[B]
    min_p: torch.Tensor              # f32[B]
    greedy: torch.Tensor             # bool[B]
    repetition_penalty: torch.Tensor  # f32[B]
    presence_penalty: torch.Tensor   # f32[B]
    frequency_penalty: torch.Tensor  # f32[B]

    @staticmethod
    def rows(requests, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side packing of SamplingParams, padded to ``batch_size``:
        ints i32[2, B] (top_k, greedy) and floats f32[6, B] (temperature,
        top_p, min_p, repetition, presence, frequency penalty), the rows
        of the JAX engine's window inputs. A step copies them into its
        own device buffers and reads them with ``from_rows``."""
        n = min(len(requests), batch_size)
        ints = np.zeros((2, batch_size), np.int32)
        ints[1] = 1                           # padding rows are greedy
        floats = np.zeros((6, batch_size), np.float32)
        floats[0] = 1.0   # temperature
        floats[1] = 1.0   # top_p
        floats[3] = 1.0   # repetition
        for i, r in enumerate(requests[:n]):
            sp = r.sampling_params
            ints[:, i] = (sp.top_k, sp.greedy)
            floats[:, i] = (max(sp.temperature, 1e-5), sp.top_p, sp.min_p,
                            sp.repetition_penalty, sp.presence_penalty,
                            sp.frequency_penalty)
        return ints, floats

    def repeat_rows(self, n: int) -> "SamplingTensors":
        """Each row repeated ``n`` times in place (a verify step's logits
        rows of one sequence)."""
        return SamplingTensors(**{
            f.name: getattr(self, f.name).repeat_interleave(n, 0)
            for f in dataclasses.fields(self)})

    @staticmethod
    def from_rows(ints: torch.Tensor, floats: torch.Tensor
                  ) -> "SamplingTensors":
        """Views of packed rows already on the device (no copy from the
        host, so a CUDA graph can capture it)."""
        return SamplingTensors(
            temperature=floats[0], top_k=ints[0].long(), top_p=floats[1],
            min_p=floats[2], greedy=ints[1].bool(),
            repetition_penalty=floats[3], presence_penalty=floats[4],
            frequency_penalty=floats[5])


def apply_penalties(logits: torch.Tensor,          # f32[B, V]
                    token_counts: torch.Tensor,    # i32[B, V]
                    st: SamplingTensors) -> torch.Tensor:
    """Repetition/presence/frequency penalties: repetition divides
    positive logits and multiplies negative ones of seen tokens; presence
    subtracts a flat value; frequency subtracts count-proportionally."""
    seen = token_counts > 0
    rep = st.repetition_penalty[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(seen, penalized, logits)
    logits = logits - torch.where(seen, st.presence_penalty[:, None], 0.0)
    return logits - token_counts.float() * st.frequency_penalty[:, None]


def mask_logits(logits: torch.Tensor, st: SamplingTensors) -> torch.Tensor:
    """Temperature + top-k + top-p + min-p masking. Returns the processed
    logits (masked entries = NEG_INF)."""
    B, V = logits.shape
    scaled = logits.float() / st.temperature[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values

    # top-k: value threshold at the k-th largest
    k = torch.where(st.top_k > 0, st.top_k, V)
    kth = torch.gather(sorted_desc, 1, (k - 1).clamp(0, V - 1)[:, None])
    mask = scaled >= kth

    # top-p: keep the smallest prefix of the sorted distribution whose
    # cumulative probability reaches top_p (first token always kept)
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = (cum - probs_sorted) < st.top_p[:, None]
    count = torch.clamp(keep_sorted.sum(dim=-1), min=1)
    p_threshold = torch.gather(sorted_desc, 1, (count - 1)[:, None])
    mask &= scaled >= p_threshold

    # min-p: prob >= min_p * max_prob  <=>  logit >= max_logit + log(min_p)
    max_logit = scaled.max(dim=-1, keepdim=True).values
    minp_thresh = max_logit + torch.log(st.min_p.clamp(min=1e-10))[:, None]
    mask &= torch.where(st.min_p[:, None] > 0, scaled >= minp_thresh, True)
    return torch.where(mask, scaled, NEG_INF)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64
    overflow (the constant is split in 16-bit halves)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer finalizer (xorshift-multiply, "lowbias32")."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seeded_gumbel(seeds: torch.Tensor, pos: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Gumbel noise f32[B, V] that is a pure function of (seed, position,
    vocab id): the counter-based draw for seeded rows."""
    row = _hash32(_hash32(seeds.long() ^ 0x5EED) ^ pos.long())     # [B]
    col = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    bits = _hash32(row[:, None] ^ _hash32(col + 0x9E3779B9)[None, :])
    u = (bits.double() + 0.5) / 4294967296.0                        # (0, 1)
    return (-torch.log(-torch.log(u))).float()


def sample(logits: torch.Tensor,                    # f32/bf16 [B, V]
           st: SamplingTensors,
           generator: Optional[torch.Generator],
           token_counts: Optional[torch.Tensor] = None,
           row_seeds: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens i64[B], logprobs f32[B]); the logprob is under the
    processed distribution. ``row_seeds`` = (seeds i32[B], positions
    i32[B]); rows with seed 0 use ``generator``."""
    logits = logits.float()
    if token_counts is not None:
        logits = apply_penalties(logits, token_counts, st)
    processed = mask_logits(logits, st)
    u = torch.rand(processed.shape, generator=generator,
                   device=processed.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    if row_seeds is not None:
        seeds, pos = row_seeds
        gumbel = torch.where((seeds != 0)[:, None],
                             seeded_gumbel(seeds, pos, processed.shape[-1]),
                             gumbel)
    sampled = torch.argmax(processed + gumbel, dim=-1)
    greedy_tok = torch.argmax(logits, dim=-1)
    tokens = torch.where(st.greedy, greedy_tok, sampled)
    logz = torch.logsumexp(processed, dim=-1)
    chosen = torch.gather(processed, 1, tokens[:, None])[:, 0]
    return tokens, chosen - logz


def rejection_sample(logits: torch.Tensor,          # f32 [R, V]
                     st: SamplingTensors,            # one row per logits row
                     generator: Optional[torch.Generator],
                     draft_ids: torch.Tensor,        # i64[R], -1 = no draft
                     token_counts: Optional[torch.Tensor] = None,
                     row_seeds: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lossless speculative acceptance for sampled rows (reference:
    speculativeDecoding rejection-sampling kernels; Leviathan et al. with
    a deterministic drafter, q = point mass). Returns (tokens i64[R],
    logprobs f32[R]) as ``sample`` does.

    - Unseeded rows, true rejection sampling: accept the draft d with
      probability p(d), else draw from p with d's mass removed
      (renormalized), so the emitted token then differs from the draft
      and acceptance stays "draft == emitted prefix". Rows without a
      draft (-1: the bonus position, padding) draw from p. Noise comes
      from ``generator``.
    - Seeded rows (``row_seeds`` = (seeds, positions), seed != 0),
      sample-and-match: the token is exactly the one ``sample`` draws
      for that (seed, position), so the stream equals non-speculative
      seeded sampling bit for bit.
    - Greedy rows emit the argmax."""
    logits = logits.float()
    if token_counts is not None:
        logits = apply_penalties(logits, token_counts, st)
    processed = mask_logits(logits, st)
    R, V = processed.shape
    probs = torch.softmax(processed, dim=-1)
    d = draft_ids.long().clamp(min=0)
    has_draft = draft_ids >= 0
    p_d = torch.gather(probs, 1, d[:, None])[:, 0]
    u = torch.rand(R, generator=generator, device=processed.device,
                   dtype=torch.float32)
    accept = has_draft & (u < p_d)
    # residual distribution: p with the rejected draft's mass removed
    onehot = F.one_hot(d, V).to(torch.float32)
    resid = torch.where(has_draft[:, None], probs * (1.0 - onehot), probs)
    rs = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(rs > 1e-9, resid / rs.clamp(min=1e-9), probs)
    g = torch.rand(processed.shape, generator=generator,
                   device=processed.device, dtype=torch.float32)
    g = -torch.log(-torch.log(g.clamp(1e-20, 1.0 - 1e-7)))
    resampled = torch.argmax(torch.log(resid.clamp(min=1e-30)) + g, dim=-1)
    sampled = torch.where(accept, d, resampled)
    if row_seeds is not None:
        seeds, pos = row_seeds
        match_tok = torch.argmax(
            processed + seeded_gumbel(seeds, pos, V), dim=-1)
        sampled = torch.where(seeds != 0, match_tok, sampled)
    greedy_tok = torch.argmax(logits, dim=-1)
    tokens = torch.where(st.greedy, greedy_tok, sampled)
    logz = torch.logsumexp(processed, dim=-1)
    chosen = torch.gather(processed, 1, tokens[:, None])[:, 0]
    return tokens, chosen - logz


def greedy_sample(logits: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-greedy fast path: argmax + its log-softmax value (no sort, no
    noise)."""
    lf = logits.float()
    tokens = torch.argmax(lf, dim=-1)
    chosen = torch.gather(lf, 1, tokens[:, None])[:, 0]
    return tokens, chosen - torch.logsumexp(lf, dim=-1)


def top_logprobs(logits: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (values, ids) of log-softmax — for SamplingParams.logprobs."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    vals, ids = torch.topk(lp, k, dim=-1)
    return vals, ids


def add_embedding_bias(logits: torch.Tensor,        # f32[R, V]
                       bias_rows: torch.Tensor      # f32[R, V]
                       ) -> torch.Tensor:
    """Per-row embedding bias folded into the logits (the JAX engine's
    ``use_bias`` branch, model_engine.py:459-465)."""
    return logits + bias_rows.to(logits.dtype)


def ban_token_ids(logits: torch.Tensor,             # f32[R, V]
                  bad_ids: torch.Tensor             # i32[R, NB], -1 = none
                  ) -> torch.Tensor:
    """Bad-word ban: each row's listed ids set to the float32 minimum,
    the value the JAX engine's logits bitmask writes
    (``jnp.where(mask, logits, finfo.min)``, model_engine.py:435-440).
    The ids are scattered into V + 1 columns, the last absorbing the
    padding, so nothing here syncs with the host."""
    R, V = logits.shape
    ids = bad_ids.long()
    cols = torch.where((ids >= 0) & (ids < V), ids, V)
    ban = torch.zeros((R, V + 1), dtype=torch.bool, device=logits.device)
    ban.scatter_(1, cols, True)
    return torch.where(ban[:, :V], NEG_INF, logits)


NGRAM_MAX = 8  # largest supported no_repeat_ngram_size (static bound)


def ngram_ban_mask(hist_rows: torch.Tensor,   # i32[S, L] per-row history
                   ngram_n: torch.Tensor,     # i32[S] (0 = off)
                   sample_idx: torch.Tensor,  # i32[S] index being sampled
                   row_valid: torch.Tensor,   # bool[S]
                   vocab_size: int) -> torch.Tensor:
    """No-repeat-ngram ban (the JAX ``ngram_ban_mask``: ban any token v
    whose appended n-gram already occurs in the sequence).

    ``hist_rows[s, i]`` holds the token at sequence index ``i`` (prompt
    and committed outputs, written by the engine). The token about to be
    sampled lands at index ``sample_idx[s]``; its preceding (n-1)-gram is
    ``hist[sample_idx-n+1 : sample_idx]``. For every earlier start j with
    ``hist[j : j+n-1]`` equal to that gram, token ``hist[j+n-1]`` is
    banned. Returns bool[S, vocab] (True = banned). The JAX version drops
    the columns of non-hits by an out-of-range scatter (``mode="drop"``);
    here they land in an extra column V that is sliced off, so the whole
    mask is device ops without a host sync and a CUDA graph captures it."""
    S, L = hist_rows.shape
    NM = NGRAM_MAX
    dev = hist_rows.device
    n = ngram_n.long()[:, None]
    at = sample_idx.long()[:, None]
    pos = torch.arange(L, device=dev)[None, :]
    # the trailing (n-1)-gram, gathered per row
    i_iota = torch.arange(NM - 1, device=dev)[None, :]
    pidx = (at - n + 1 + i_iota).clamp(0, L - 1)
    pvalid = i_iota < (n - 1)
    pref = torch.gather(hist_rows, 1, pidx)
    # window match at every start j (shifted slice compares)
    hp = F.pad(hist_rows, (0, NM), value=-1)
    match = torch.ones((S, L), dtype=torch.bool, device=dev)
    for i in range(NM - 1):
        eq = hp[:, i:i + L] == pref[:, i:i + 1]
        match &= eq | ~pvalid[:, i:i + 1]
    # j must leave room for the full n-gram strictly before sample_idx
    valid_j = (pos <= at - n) & (n > 0) & row_valid[:, None]
    btok = torch.gather(hist_rows, 1, (pos + n - 1).clamp(0, L - 1)).long()
    cols = torch.where(match & valid_j & (btok >= 0) & (btok < vocab_size),
                       btok, vocab_size)
    ban = torch.zeros((S, vocab_size + 1), dtype=torch.bool, device=dev)
    ban.scatter_(1, cols, True)
    return ban[:, :vocab_size]
