"""Timing and input helpers shared by the scripts that measure the CUDA
kernels on the card (``chip_smoke.py``, ``tools/attention_sweep.py``)."""
from __future__ import annotations

import statistics

PAGE = 32     # the serving path's default tokens_per_block


def time_ms(fn, reps: int = 30) -> float:
    """Median of per-launch CUDA-event times, after warm-up. The launches
    are queued behind a ~25 ms device sleep, so the card runs them back to
    back and a launch's time is the kernel's, not the host's enqueue gap
    (a function that syncs inside, like the plain prefill loop, still
    pays its host time)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def make_case(q_lens, ctx_lens, qh, kvh, hd, seed, page=PAGE, dtype=None,
              pages_per_seq=0):
    """Packed queries (bf16 unless ``dtype``) and a shuffled paged pool on
    the card: q, pool, kv_lens, page table, cu_q_lens. The page table has
    ``pages_per_seq`` columns (an engine's width) where that is more than
    the longest row needs."""
    import torch
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    S = len(q_lens)
    kv = [c + q for c, q in zip(ctx_lens, q_lens)]
    maxp = max(pages_per_seq, max(-(-k // page) for k in kv))
    P = S * maxp + 1
    pool = torch.randn((P, page, 2 * kvh, hd), generator=g, device="cuda",
                       dtype=dtype)
    pt = torch.randperm(S * maxp, generator=g, device="cuda") \
        .to(torch.int32).reshape(S, maxp)
    q = torch.randn((sum(q_lens), qh, hd), generator=g, device="cuda",
                    dtype=dtype)
    cu = torch.zeros(S + 1, dtype=torch.int32, device="cuda")
    cu[1:] = torch.cumsum(torch.tensor(q_lens, device="cuda"), 0)
    kv_lens = torch.tensor(kv, dtype=torch.int32, device="cuda")
    return q, pool, kv_lens, pt, cu


def dense_kv(pool, pt, kvh, hd, kv_len):
    """Gathered [S, kvh, kv_len, hd] K and V: the first ``kv_len``
    positions of every row of the page table."""
    S = pt.shape[0]
    pages = pool[pt.reshape(-1).long()].reshape(S, -1, 2 * kvh, hd)[:, :kv_len]
    k = pages[:, :, 0::2].transpose(1, 2).contiguous()
    v = pages[:, :, 1::2].transpose(1, 2).contiguous()
    return k, v
