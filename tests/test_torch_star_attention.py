"""STAR prefill attention of the port (tensorrt_llm_tpu_torch/ops/
attention.py: the STAR mask in ``_reference_attention`` and
``star_reference_attention``, and the prefill kernel over
``star_launches``' virtual sequences, with and without a sliding window)
against the JAX ``_reference_attention(star_block_size=...)``."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorrt_llm_tpu.ops import attention as jattn
from tensorrt_llm_tpu_torch.ops import attention as tattn
from tensorrt_llm_tpu_torch.ops.cuda import prefill_attention as k2

PS, BLOCK, P = 8, 16, 8


def _batch(segments, kvh=2, qh=4, hd=16, seed=0):
    """(q, pool, host arrays) of a step whose sequence i holds
    ``segments[i]`` = (q_len, kv_len): random K/V at every position below
    kv_len, on shuffled pages."""
    r = np.random.default_rng(seed)
    S = len(segments)
    pool = r.standard_normal((S * P + 1, PS, 2 * kvh, hd)).astype(np.float32)
    table = r.permutation(S * P).reshape(S, P).astype(np.int32)
    q_lens = np.array([n for n, _ in segments], np.int32)
    kv_lens = np.array([L for _, L in segments], np.int32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    T = int(cu[-1])
    pos = np.concatenate([np.arange(L - n, L) for n, L in segments])
    slots = np.concatenate([
        table[i, np.arange(L - n, L) // PS] * PS + np.arange(L - n, L) % PS
        for i, (n, L) in enumerate(segments)]).astype(np.int32)
    q = r.standard_normal((T, qh, hd)).astype(np.float32)
    return q, pool, dict(kv_lens=kv_lens, page_indices=table, cu_q_lens=cu,
                         num_seqs=np.array([S], np.int32),
                         slot_mapping=slots, positions=pos.astype(np.int32),
                         logits_indices=(cu[1:] - 1).astype(np.int32))


def _jax_star(q, pool, host, hd=16, window=None):
    md = jattn.AttentionMetadata(**{k: jnp.asarray(v)
                                    for k, v in host.items()})
    return np.asarray(jattn.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(pool), md, sm_scale=hd ** -0.5,
        backend="reference", star_block_size=BLOCK, sliding_window=window))


def _star_md(host, n, window=None):
    """Port metadata of a step whose STAR launches go to the kernel."""
    return _port_md(host, star_segments=tattn.star_metadata(
        host["cu_q_lens"], host["kv_lens"], host["page_indices"], n, BLOCK,
        PS, (window,), "cpu"))


def _port_md(host, **kw):
    return tattn.AttentionMetadata(
        **{k: torch.from_numpy(np.asarray(v)) for k, v in host.items()},
        max_q_len=int(np.diff(host["cu_q_lens"]).max()), **kw)


# (q_len, kv_len) per sequence: a chunk inside block 0, a chunk inside
# block 2, a chunk across two block edges, a chunk ending on an edge, a
# one-token prompt chunk in block 1 and a decode row
STEPS = {
    "block0": [(12, 12)],
    "inside": [(9, 45)],
    "across": [(31, 41)],
    "edge_end": [(20, 32)],
    "mixed": [(12, 12), (9, 45), (31, 41), (1, 20), (1, 51)],
}


@pytest.mark.parametrize("name", sorted(STEPS))
@pytest.mark.parametrize("route", ("remap", "plain"))
def test_star_matches_jax(name, route):
    """The prefill kernel's plain version over the virtual sequences
    (``remap``) and ``_reference_attention`` with the STAR mask
    (``plain``, the route of a block that is not a whole number of pages)
    against the JAX STAR reference, float32 to 1e-5."""
    q, pool, host = _batch(STEPS[name])
    ref = _jax_star(q, pool, host)
    if route == "remap":
        md = _star_md(host, len(STEPS[name]))
    else:
        md = _port_md(host, star_block_size=BLOCK)
    before = k2.LAUNCHES_STAR
    got = tattn.ragged_paged_attention(
        torch.from_numpy(q), torch.from_numpy(pool), md, sm_scale=0.25)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert k2.LAUNCHES_STAR == before          # the CPU launches nothing
    # the same mask in the port's own reference
    ref_t = tattn._reference_attention(
        torch.from_numpy(q), torch.from_numpy(pool), _port_md(host),
        sm_scale=0.25, star_block_size=BLOCK)
    np.testing.assert_allclose(ref_t.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_star_differs_from_causal_past_two_blocks():
    """Past two blocks STAR is not causal attention (rows of block 2 skip
    block 1), within two blocks it is."""
    q, pool, host = _batch([(9, 45)])
    causal = tattn._reference_attention(
        torch.from_numpy(q), torch.from_numpy(pool), _port_md(host),
        sm_scale=0.25)
    assert not np.allclose(causal.numpy(), _jax_star(q, pool, host),
                           atol=1e-3)
    q, pool, host = _batch([(12, 28)])
    causal = tattn._reference_attention(
        torch.from_numpy(q), torch.from_numpy(pool), _port_md(host),
        sm_scale=0.25)
    np.testing.assert_allclose(causal.numpy(), _jax_star(q, pool, host),
                               rtol=1e-5, atol=1e-5)


def test_star_segments_layout():
    """A chunk across block edges is cut per block: block 0 keeps its
    table, a later block gets block 0's pages then its own, and the
    virtual length is block + the rows' reach into their block."""
    cu = np.array([0, 31, 32], np.int32)
    kv = np.array([41, 51], np.int32)
    table = np.arange(2 * P, dtype=np.int32).reshape(2, P)
    (launch,) = tattn.star_launches(cu, kv, table, 2, BLOCK, PS)
    lens, cu_v, pages, max_q = launch[:4]
    assert launch.rows is None and launch.window is None
    assert lens.tolist() == [16, 32, 25, 51]
    assert cu_v.tolist() == [0, 6, 22, 31, 32] and max_q == 16
    assert pages[0].tolist() == table[0].tolist()
    assert pages[2, :4].tolist() == [0, 1, 4, 5]
    assert pages[3].tolist() == table[1].tolist()
    with pytest.raises(ValueError, match="whole number"):
        tattn.star_launches(cu, kv, table, 2, 12, PS)


def test_layer_metadata_moves_the_virtual_table():
    q, pool, host = _batch([(40, 64)])
    md = _star_md(host, 1, window=20)
    md2 = tattn.layer_metadata(md, 2, 100, PS, 4)
    assert len(md2.star_segments[20]) == 2
    for a, b in zip(md.star_segments[20], md2.star_segments[20]):
        assert torch.equal(b.page_indices, a.page_indices + 200)
        assert torch.equal(b.rows, a.rows) and b.window == a.window
    assert dataclasses.replace(md2, star_segments=None).star_segments \
        is None


# windows shorter than a block, equal to it, reaching into block 2 from
# block 0 (20, 30: rows of block 2 split at block + window), past it (40)
# and past every position (100); steps with chunks in blocks 2 and 3
WINDOWS = (5, 16, 20, 30, 40, 100)
WINDOW_STEPS = {
    "late": [(40, 64)],
    "mixed": [(12, 12), (9, 45), (31, 62), (1, 20), (1, 51)],
}


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("name", sorted(WINDOW_STEPS))
@pytest.mark.parametrize("route", ("remap", "plain"))
def test_star_window_matches_jax(route, name, window):
    """Under a sliding window the remap's launches (each at its window,
    over the rows that need it) and the plain STAR route against the JAX
    STAR reference with the window, float32 to 1e-5."""
    steps = WINDOW_STEPS[name]
    q, pool, host = _batch(steps, seed=3)
    ref = _jax_star(q, pool, host, window=window)
    md = _star_md(host, len(steps), window) if route == "remap" else \
        _port_md(host, star_block_size=BLOCK)
    got = tattn.ragged_paged_attention(
        torch.from_numpy(q), torch.from_numpy(pool), md, sm_scale=0.25,
        sliding_window=window)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_star_window_launch_layout():
    """Rows 24-63 of one sequence, blocks of 16, window 20: rows of block
    1 and rows from block + window = 36 on take the window as it is (the
    latter over their own block's pages alone); rows 32-35 of block 2 take
    block 0 then block 2 with the window shortened by one block, 4."""
    cu = np.array([0, 40], np.int32)
    kv = np.array([64], np.int32)
    table = np.arange(P, dtype=np.int32)[None] + 10
    launches = tattn.star_launches(cu, kv, table, 1, BLOCK, PS, window=20)
    by_win = {ln.window: ln for ln in launches}
    assert sorted(by_win) == [4, 20]
    full, short = by_win[20], by_win[4]
    assert short.rows.tolist() == list(range(8, 12))
    assert short.kv_lens.tolist() == [20]
    assert short.page_indices[0, :4].tolist() == [10, 11, 14, 15]
    assert full.rows.tolist() == list(range(8)) + list(range(12, 40))
    assert full.kv_lens.tolist() == [32, 16, 16]
    assert full.cu_q_lens.tolist() == [0, 8, 20, 36]
    assert full.page_indices[1, :2].tolist() == [14, 15]
    assert full.page_indices[2, :2].tolist() == [16, 17]
    # no window: one launch over every row, in order
    (one,) = tattn.star_launches(cu, kv, table, 1, BLOCK, PS)
    assert one.rows is None and one.window is None


def test_star_plain_route_in_chunks(monkeypatch):
    """``star_reference_attention`` attends a sequence's rows in chunks
    (here of 3 rows, forced by a small byte budget; a chunk may hold one
    row of a prompt segment) and equals ``_reference_attention`` with the
    STAR mask, a window and a soft cap, on a step with decode rows."""
    q, pool, host = _batch(WINDOW_STEPS["mixed"], seed=5)
    kw = dict(sm_scale=0.25, sliding_window=30, soft_cap=5.0,
              star_block_size=BLOCK)
    ref = tattn._reference_attention(torch.from_numpy(q),
                                     torch.from_numpy(pool), _port_md(host),
                                     **kw)
    monkeypatch.setattr(tattn, "STAR_PLAIN_CHUNK_BYTES", 3 * 4 * 4 * 64)
    got = tattn.star_reference_attention(torch.from_numpy(q),
                                         torch.from_numpy(pool),
                                         _port_md(host), **kw)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
