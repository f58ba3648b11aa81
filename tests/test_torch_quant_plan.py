"""The dequant-matmul kernel's split of K across the CTAs of a cluster, as
pure functions of host ints (``ops/cuda/quant_matmul.py``): every group
of both halves covered exactly once, in whole groups, by at most eight
CTAs, with about one CTA per SM at the serving shapes and at the shapes
of the card tests."""
import inspect

import pytest

from tensorrt_llm_tpu_torch.ops.cuda import quant_matmul as qmm

H100_SMS = 132

# (M, K, N, group, bits): the serving shapes of the TinyLlama-1.1B
# geometry at 64 and 16 rows, then the card tests' shapes
SERVING = [(64, 2048, 2560, 128, 4), (64, 2048, 2048, 128, 4),
           (64, 2048, 11264, 128, 4), (64, 5632, 2048, 128, 4),
           (16, 2048, 2560, 128, 4), (16, 2048, 2048, 128, 4),
           (16, 2048, 11264, 128, 4), (16, 5632, 2048, 128, 4)]
CARD = [(1, 2048, 2560, 128, 4), (8, 512, 384, 64, 4), (17, 256, 257, 32, 4),
        (33, 256, 1001, 64, 8), (128, 2048, 2048, 128, 4),
        (100, 1024, 130, 16, 4), (64, 2048, 2560, 32, 8),
        (64, 2048, 2560, 16, 8), (5, 48, 8, 16, 8), (65, 1024, 1024, 64, 4),
        (120, 5632, 384, 128, 4), (128, 1024, 257, 32, 4),
        (64, 512, 8, 16, 4), (64, 1536, 130, 64, 4), (1, 1024, 130, 128, 8),
        (40, 2048, 1001, 32, 8), (24, 768, 257, 16, 8),
        (64, 5632, 2048, 16, 8)]


def _groups(K, G, bits):
    return (K // 2 if bits == 4 else K) // G


def split_plan(K: int, G: int, bits: int, splits: int):
    """The (half, group) pairs of the scale rows each CTA along K covers,
    from the kernel's share of chunks; int4 takes both halves of a stored
    group from the same bytes (half 1 is K/2 further on)."""
    stored = K // 2 if bits == 4 else K
    ch = qmm.chunk_rows(G)
    plan = []
    for first, count in qmm.split_chunks(qmm.num_chunks(K, G, bits), splits):
        rows = range(first * ch, min((first + count) * ch, stored), G)
        plan.append([(h, r // G) for r in rows
                     for h in range(2 if bits == 4 else 1)])
    return plan


@pytest.mark.parametrize("sms", [H100_SMS, 114, 16, 1])
@pytest.mark.parametrize("M,K,N,G,bits", SERVING + CARD)
def test_every_group_of_both_halves_once(M, K, N, G, bits, sms):
    splits = qmm.choose_splits(M, K, N, G, bits, sms)
    plan = split_plan(K, G, bits, splits)
    assert len(plan) == splits
    covered = [pair for cta in plan for pair in cta]
    halves = 2 if bits == 4 else 1
    want = [(h, g) for g in range(_groups(K, G, bits)) for h in range(halves)]
    assert sorted(covered) == sorted(want)
    assert len(covered) == len(set(covered))


@pytest.mark.parametrize("M,K,N,G,bits", SERVING + CARD)
def test_slices_are_whole_runs_of_groups(M, K, N, G, bits):
    """Each CTA takes a run of whole chunks, a chunk being whole groups
    (one group, or 64 stored rows of smaller groups), and the runs differ
    in length by at most one chunk."""
    ch = qmm.chunk_rows(G)
    assert ch % G == 0
    splits = qmm.choose_splits(M, K, N, G, bits, H100_SMS)
    shares = qmm.split_chunks(qmm.num_chunks(K, G, bits), splits)
    counts = [n for _, n in shares]
    assert max(counts) - min(counts) <= 1
    assert counts == sorted(counts, reverse=True)
    nxt = 0
    for first, n in shares:
        assert first == nxt
        nxt = first + n
    assert nxt == qmm.num_chunks(K, G, bits)
    for cta in split_plan(K, G, bits, splits):
        for h in {h for h, _ in cta}:
            gs = [g for hh, g in cta if hh == h]
            assert gs == list(range(gs[0], gs[0] + len(gs)))


@pytest.mark.parametrize("sms", [H100_SMS, 114, 16, 1])
@pytest.mark.parametrize("M,K,N,G,bits", SERVING + CARD)
def test_cluster_size_and_one_cta_per_sm(M, K, N, G, bits, sms):
    """A power of two within the cluster cap (at most 8, the portable
    cluster size); the grid stays within one CTA per SM unless a single
    split already exceeds it, and doubling the split would not fit unless
    a cap stopped it."""
    splits = qmm.choose_splits(M, K, N, G, bits, sms)
    assert qmm.MAX_SPLITS <= 8
    assert splits in (1, 2, 4, 8) and splits <= qmm.MAX_SPLITS
    tiles = -(-N // qmm.TILE_N) * -(-M // qmm.ROW_BLOCK)
    if splits > 1:
        assert tiles * splits <= sms
    capped = 2 * splits > min(qmm.MAX_SPLITS, qmm.num_chunks(K, G, bits))
    assert capped or tiles * 2 * splits > sms


def test_serving_shapes_fill_the_h100():
    """At 132 SMs: qkv 20 tiles x 4, o 16 x 4, gate_up 88 x 1, down
    16 x 4 (its 22 chunks as 6,6,5,5): between half the SMs and all of
    them, and one more doubling would pass the SM count or the cap."""
    got = [qmm.choose_splits(M, K, N, G, b, H100_SMS)
           for M, K, N, G, b in SERVING[:4]]
    assert got == [4, 4, 1, 4]
    assert [n for _, n in qmm.split_chunks(22, 4)] == [6, 6, 5, 5]
    for M, K, N, G, b in SERVING:
        splits = qmm.choose_splits(M, K, N, G, b, H100_SMS)
        ctas = -(-N // qmm.TILE_N) * splits
        assert H100_SMS // 2 <= ctas * 2 and ctas <= H100_SMS
        assert splits == qmm.MAX_SPLITS or 2 * ctas > H100_SMS


def test_split_rule_reads_host_ints_only():
    """The rule and the plan take ints and return ints (no tensor, no
    device query), so the grid of a shape is fixed and capturable."""
    for fn in (qmm.choose_splits, qmm.split_chunks, qmm.num_chunks,
               qmm.chunk_rows):
        params = inspect.signature(fn).parameters.values()
        assert all(p.annotation in (int, "int") for p in params), fn
    a = qmm.choose_splits(64, 5632, 2048, 128, 4, 132)
    b = qmm.choose_splits(64, 5632, 2048, 128, 4, 132)
    assert a == b and type(a) is int
