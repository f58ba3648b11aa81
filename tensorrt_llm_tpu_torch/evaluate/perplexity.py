"""Teacher-forced scoring: per-position prompt log-probabilities.

Port of ``tensorrt_llm_tpu/evaluate/perplexity.py``
(``score_token_logprobs``, ``perplexity``, ``prompt_logprob_dicts``):
the model runs one teacher-forced prefill over the tokens in a paged pool
of its own (ceil(T / page) + 1 pages, freed when the call returns), with
logits at every position, and the log-softmax is taken in float32.

The JAX version takes the whole [T, V] logits to the host. At a
published vocabulary that is 1.05 GB at T = 2,048 (V = 128,256), so here
the prefill runs in chunks of ``chunk`` query rows over the same pool
(each chunk's queries attend to the keys of every earlier chunk, as one
pass would: the prefill attention kernel on the card), each chunk's
logits are projected and log-softmaxed on the device, and only each
position's prompt-token value and its ``top_k`` most likely tokens come
to the host. A chunk as long as the tokens is the JAX version's one
pass.
"""
from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.attention import AttentionMetadata

# query rows per teacher-forced chunk: its float32 logits are
# 256 x 128,256 x 4 B = 131 MB at Llama-3's vocabulary
PROMPT_LOGPROB_CHUNK = 256


@torch.no_grad()
def _chunks(model, params, token_ids: Sequence[int], page_size: int,
            chunk: int) -> Iterator[Tuple[int, torch.Tensor]]:
    """(first row, float32 log-softmax [rows, V] on the model's device) of
    each chunk of the teacher-forced prefill over ``token_ids``."""
    T = len(token_ids)
    num_pages = -(-T // page_size) + 1
    dev = model.device
    vswa = bool(getattr(model, "vswa_enabled", False))
    # a recurrent model's state pools hold slot 0 and the trash slot
    recurrent = bool(getattr(model, "has_recurrent_state", False))
    # under VSWA the sliding layers get a pool of their own as long as the
    # global one (the kernels apply their window)
    kv = model.make_kv_pages(num_pages, page_size, **(
        {"num_sw_pages": num_pages} if vswa else {}))
    i32 = dict(dtype=torch.int32, device=dev)
    pages = torch.arange(num_pages, **i32)[None, :]
    tokens = torch.as_tensor(np.asarray(token_ids, np.int64)).to(dev)
    for a in range(0, T, chunk):
        b = min(T, a + chunk)
        slots = torch.arange(a, b, **i32)
        sw = dict(page_indices_sw=pages, slot_mapping_sw=slots) if vswa \
            else {}
        md = AttentionMetadata(
            kv_lens=torch.tensor([b], **i32), page_indices=pages,
            cu_q_lens=torch.tensor([0, b - a], **i32),
            num_seqs=torch.tensor([1], **i32), slot_mapping=slots,
            positions=slots,
            # logits at every position (prediction targets are t + 1)
            logits_indices=torch.arange(b - a, **i32),
            max_q_len=b - a, max_kv_len=b,
            seq_slots=torch.zeros(1, **i32) if recurrent else None, **sw)
        logits, kv = model.forward(params, tokens[a:b], kv, md)[:2]
        yield a, torch.log_softmax(logits.float(), dim=-1)


def _rows(model, params, token_ids: Sequence[int], top_k: int,
          page_size: int, chunk: int):
    """For t = 1..T-1: log p(token_t | tokens_<t) (float32 [T-1]) and with
    ``top_k`` the top-k (values, ids) of position t's distribution."""
    T = len(token_ids)
    tgt = torch.as_tensor(np.asarray(token_ids, np.int64))
    lps, vals, ids = [], [], []
    for a, lp in _chunks(model, params, token_ids, page_size, chunk):
        n = min(a + lp.shape[0], T - 1) - a     # rows with a next token
        if n <= 0:
            continue
        nxt = tgt[a + 1:a + 1 + n].to(lp.device)
        lps.append(lp[:n].gather(1, nxt[:, None])[:, 0].cpu())
        if top_k > 0:
            v, i = torch.topk(lp[:n], min(top_k, lp.shape[1]), dim=-1)
            vals.append(v.cpu())
            ids.append(i.cpu())
    cat = (lambda xs: torch.cat(xs).numpy())
    if not lps:
        return np.zeros(0, np.float32), None, None
    return (cat(lps), cat(vals) if vals else None,
            cat(ids) if ids else None)


def score_token_logprobs(model, params, token_ids: Sequence[int],
                         page_size: int = 32,
                         chunk: int = PROMPT_LOGPROB_CHUNK) -> np.ndarray:
    """log p(token_t | tokens_<t) for t = 1..T-1. Returns float32 [T-1]."""
    return _rows(model, params, token_ids, 0, page_size, chunk)[0]


def perplexity(model, params, token_ids: Sequence[int],
               page_size: int = 32,
               chunk: int = PROMPT_LOGPROB_CHUNK) -> float:
    lp = score_token_logprobs(model, params, token_ids, page_size, chunk)
    return float(math.exp(-lp.mean()))


def prompt_logprob_dicts(model, params, token_ids: Sequence[int],
                         top_k: int = 0, page_size: int = 32,
                         chunk: int = PROMPT_LOGPROB_CHUNK
                         ) -> List[Optional[dict]]:
    """vLLM-style ``SamplingParams.prompt_logprobs`` payload: one entry
    per prompt position, ``None`` for position 0 (no context), then a
    ``{token_id: logprob}`` dict holding the actual prompt token plus the
    ``top_k`` most likely tokens at that position. The JAX version picks
    those with ``np.argpartition`` over the host row; here ``torch.topk``
    picks them on the device, the same set unless two logits tie exactly
    at the k-th value."""
    lp, vals, ids = _rows(model, params, token_ids, top_k, page_size, chunk)
    out: List[Optional[dict]] = [None]
    for t in range(1, len(token_ids)):
        entry = {int(token_ids[t]): float(lp[t - 1])}
        if top_k > 0:
            for v, tok in zip(vals[t - 1].tolist(), ids[t - 1].tolist()):
                entry[int(tok)] = float(v)
        out.append(entry)
    return out
