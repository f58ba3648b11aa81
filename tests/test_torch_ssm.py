"""The port's recurrent mixers (tensorrt_llm_tpu_torch/ops/ssm.py) against
the JAX package's ops/ssm.py, float32, CPU.

Each scan runs in its plain, bounded and one-step forms on ragged mixed
batches: a fresh prompt, a segment that continues from its slot's state,
decode rows, an inactive row and padding tokens past the last row. The
outputs of the rows' tokens and the slots' new states agree with the JAX
function's within ``ATOL``; the port's pools carry one more row than the
JAX ones, the trash slot, which absorbs what the JAX functions drop. The
bounded SSD form is also run with chunks shorter than the segments, so
that states pass between chunks. A recycled slot (position 0 over a
stale state) starts fresh.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ATOL = 2e-4


@dataclasses.dataclass
class Batch:
    """A ragged step: segment lengths and first positions per row (row
    order), each row's slot (-1: inactive) and the padded token count."""
    lens: list
    starts: list
    slots: list
    T: int

    def arrays(self):
        S = len(self.lens)
        cu = np.zeros(S + 1, np.int32)
        cu[1:] = np.cumsum(self.lens)
        pos = np.zeros(self.T, np.int32)
        for i, (n, p) in enumerate(zip(self.lens, self.starts)):
            pos[cu[i]:cu[i] + n] = np.arange(p, p + n)
        n_act = sum(1 for n in self.lens if n)
        return dict(kv_lens=np.asarray([p + n for n, p in zip(
            self.lens, self.starts)], np.int32), cu_q_lens=cu,
            num_seqs=np.asarray([n_act], np.int32), positions=pos,
            seq_slots=np.asarray(self.slots, np.int32),
            max_q_len=max(self.lens))

    def jax_md(self):
        from tensorrt_llm_tpu.ops.attention import AttentionMetadata
        a = self.arrays()
        S = len(self.lens)
        return AttentionMetadata(
            kv_lens=jnp.asarray(a["kv_lens"]),
            page_indices=jnp.zeros((S, 1), jnp.int32),
            cu_q_lens=jnp.asarray(a["cu_q_lens"]),
            num_seqs=jnp.asarray(a["num_seqs"]),
            slot_mapping=jnp.zeros(self.T, jnp.int32),
            positions=jnp.asarray(a["positions"]),
            logits_indices=jnp.zeros(S, jnp.int32),
            seq_slots=jnp.asarray(a["seq_slots"]))

    def torch_md(self):
        from tensorrt_llm_tpu_torch.ops.attention import AttentionMetadata
        a = self.arrays()
        S = len(self.lens)
        t = torch.from_numpy
        return AttentionMetadata(
            kv_lens=t(a["kv_lens"]), page_indices=torch.zeros(
                S, 1, dtype=torch.int32), cu_q_lens=t(a["cu_q_lens"]),
            num_seqs=t(a["num_seqs"]), slot_mapping=torch.zeros(
                self.T, dtype=torch.int32), positions=t(a["positions"]),
            logits_indices=torch.zeros(S, dtype=torch.int32),
            max_q_len=a["max_q_len"], seq_slots=t(a["seq_slots"]))

    def token_mask(self):
        m = np.zeros(self.T, bool)
        m[:sum(self.lens)] = True
        return m


SLOTS = 3
# a fresh 9-token prompt (slot 2), a 6-token segment continuing at
# position 5 (slot 0), a decode row (slot 1), an inactive row, padding
MIXED = Batch(lens=[9, 6, 1, 0], starts=[0, 5, 12, 0],
              slots=[2, 0, 1, -1], T=20)
# one token per row: continuing rows, a fresh one, an inactive one
DECODE = Batch(lens=[1, 1, 1, 0], starts=[7, 0, 3, 0],
               slots=[1, 2, 0, -1], T=6)
# no padding tokens (the JAX delta rule writes a padding token's update
# into slot 0; see ROADMAP "Reference faults")
MIXED_EXACT = Batch(lens=[9, 6, 1, 0], starts=[0, 5, 12, 0],
                    slots=[2, 0, 1, -1], T=16)
DECODE_EXACT = Batch(lens=[1, 1, 1, 0], starts=[7, 0, 3, 0],
                     slots=[1, 2, 0, -1], T=3)


def _pools(shape, rng):
    """A JAX pool [SLOTS, ...] and the port's [SLOTS + 1, ...] with the
    same rows (the last one the trash slot)."""
    p = rng.standard_normal((SLOTS,) + shape).astype(np.float32)
    trash = np.full((1,) + shape, 7.0, np.float32)
    return jnp.asarray(p), torch.from_numpy(np.concatenate([p, trash]))


def _check(batch, jy, ty, jstate, tstate):
    m = batch.token_mask()
    np.testing.assert_allclose(ty.numpy()[m], np.asarray(jy)[m],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tstate.numpy()[:SLOTS], np.asarray(jstate),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("batch", [MIXED, DECODE], ids=["mixed", "decode"])
def test_causal_conv1d_matches_jax(batch):
    from tensorrt_llm_tpu.ops import ssm as jssm
    from tensorrt_llm_tpu_torch.ops import ssm
    rng = np.random.default_rng(0)
    I, k = 12, 4
    x = rng.standard_normal((batch.T, I)).astype(np.float32)
    w = rng.standard_normal((I, k)).astype(np.float32)
    b = rng.standard_normal(I).astype(np.float32)
    jpool, tpool = _pools((I, k - 1), rng)
    jy, jnew = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), jpool, batch.jax_md())
    ty = ssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b), tpool, batch.torch_md())
    _check(batch, jy, ty, jnew, tpool)


def _selective_inputs(T, rng, I=6, N=4):
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=r(T, I), dt=np.abs(r(T, I)) * 0.5,
                A=-np.exp(r(I, N) * 0.5), B=r(T, N), C=r(T, N), D=r(I))


@pytest.mark.parametrize("form,batch", [
    ("plain", MIXED), ("bounded", MIXED), ("plain", DECODE),
    ("step", DECODE), ("bounded", DECODE)])
def test_selective_scan_matches_jax(form, batch, monkeypatch):
    from tensorrt_llm_tpu.ops import ssm as jssm
    from tensorrt_llm_tpu_torch.ops import ssm
    # blocks of 4 tokens: the carry crosses block edges mid-segment
    monkeypatch.setattr(ssm, "SCAN_BLOCK_BYTES", 4 * 4 * 4 * 6 * 4)
    rng = np.random.default_rng(1)
    a = _selective_inputs(batch.T, rng)
    jpool, tpool = _pools((6, 4), rng)
    jy, jnew = jssm.selective_scan(
        *[jnp.asarray(a[n]) for n in ("x", "dt", "A", "B", "C", "D")],
        jpool, batch.jax_md())
    ty = ssm.selective_scan(
        *[torch.from_numpy(a[n]) for n in ("x", "dt", "A", "B", "C", "D")],
        tpool, batch.torch_md(), form=form)
    _check(batch, jy, ty, jnew, tpool)


def _ssd_inputs(T, rng, nh=4, hd=3, G=2, N=5):
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=r(T, nh, hd), dt=np.abs(r(T, nh)) * 0.5,
                A=-np.exp(r(nh) * 0.5), B=r(T, G, N), C=r(T, G, N),
                D=r(nh))


@pytest.mark.parametrize("form,batch,chunk", [
    ("plain", MIXED, 256), ("bounded", MIXED, 256), ("bounded", MIXED, 4),
    ("bounded", MIXED, 1), ("plain", DECODE, 256), ("step", DECODE, 256),
    ("bounded", DECODE, 2)])
def test_ssd_scan_matches_jax(form, batch, chunk):
    from tensorrt_llm_tpu.ops import ssm as jssm
    from tensorrt_llm_tpu_torch.ops import ssm
    rng = np.random.default_rng(2)
    a = _ssd_inputs(batch.T, rng)
    jpool, tpool = _pools((4, 3, 5), rng)
    names = ("x", "dt", "A", "B", "C", "D")
    jy, jnew = jssm.ssd_scan(*[jnp.asarray(a[n]) for n in names], jpool,
                             batch.jax_md())
    ty = ssm.ssd_scan(*[torch.from_numpy(a[n]) for n in names], tpool,
                      batch.torch_md(), form=form, chunk=chunk)
    _check(batch, jy, ty, jnew, tpool)


def _delta_inputs(T, rng, vh=4, dk=3, dv=5):
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k = r(T, vh, dk), r(T, vh, dk)
    q /= np.linalg.norm(q, axis=-1, keepdims=True) * np.sqrt(dk)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    return dict(q=q, k=k, v=r(T, vh, dv), g=-np.abs(r(T, vh)) * 0.3,
                beta=1 / (1 + np.exp(-r(T, vh))))


@pytest.mark.parametrize("form,batch", [
    ("plain", MIXED_EXACT), ("bounded", MIXED_EXACT),
    ("plain", DECODE_EXACT), ("step", DECODE_EXACT)])
def test_gated_delta_scan_matches_jax(form, batch):
    from tensorrt_llm_tpu.ops import ssm as jssm
    from tensorrt_llm_tpu_torch.ops import ssm
    rng = np.random.default_rng(3)
    a = _delta_inputs(batch.T, rng)
    jpool, tpool = _pools((4, 3, 5), rng)
    names = ("q", "k", "v", "g", "beta")
    jy, jnew = jssm.gated_delta_scan(*[jnp.asarray(a[n]) for n in names],
                                     jpool, batch.jax_md())
    ty = ssm.gated_delta_scan(*[torch.from_numpy(a[n]) for n in names],
                              tpool, batch.torch_md(), form=form)
    _check(batch, jy, ty, jnew, tpool)


def test_delta_padding_goes_to_the_trash_slot():
    """Padding tokens leave every slot's state as the rows left it (the
    port's bounded form against its padding-free run)."""
    from tensorrt_llm_tpu_torch.ops import ssm
    rng = np.random.default_rng(4)
    a = _delta_inputs(MIXED.T, rng)
    _, pool = _pools((4, 3, 5), rng)
    pool2 = pool.clone()
    names = ("q", "k", "v", "g", "beta")
    y = ssm.gated_delta_scan(*[torch.from_numpy(a[n]) for n in names],
                             pool, MIXED.torch_md())
    y2 = ssm.gated_delta_scan(
        *[torch.from_numpy(a[n][:MIXED_EXACT.T]) for n in names], pool2,
        MIXED_EXACT.torch_md())
    torch.testing.assert_close(y[:MIXED_EXACT.T], y2)
    torch.testing.assert_close(pool[:SLOTS], pool2[:SLOTS])


@pytest.mark.parametrize("scan", ["selective", "ssd", "delta", "conv"])
def test_recycled_slot_starts_fresh(scan):
    """A prompt at position 0 in a slot with a stale state gives what it
    gives in a zeroed slot, in every form."""
    from tensorrt_llm_tpu_torch.ops import ssm
    rng = np.random.default_rng(5)
    batch = Batch(lens=[5, 0], starts=[0, 0], slots=[1, -1], T=6)
    md = batch.torch_md()
    if scan == "selective":
        a = _selective_inputs(batch.T, rng)
        args = [torch.from_numpy(a[n]) for n in ("x", "dt", "A", "B", "C",
                                                 "D")]
        shape, fn, forms = (6, 4), ssm.selective_scan, ("plain", "bounded")
    elif scan == "ssd":
        a = _ssd_inputs(batch.T, rng)
        args = [torch.from_numpy(a[n]) for n in ("x", "dt", "A", "B", "C",
                                                 "D")]
        shape, fn, forms = (4, 3, 5), ssm.ssd_scan, ("plain", "bounded")
    elif scan == "delta":
        a = _delta_inputs(batch.T, rng)
        args = [torch.from_numpy(a[n]) for n in ("q", "k", "v", "g",
                                                 "beta")]
        shape, fn, forms = (4, 3, 5), ssm.gated_delta_scan, \
            ("plain", "bounded")
    else:
        x = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32))
        args = [x, w, torch.zeros(8)]
        shape, forms = (8, 3), (None,)

        def fn(*a, form=None):
            return ssm.causal_conv1d(*a)
    for form in forms:
        stale = torch.full((SLOTS + 1,) + shape, 3.0)
        zero = torch.zeros((SLOTS + 1,) + shape)
        y1 = fn(*args, stale, md, form=form)
        y0 = fn(*args, zero, md, form=form)
        torch.testing.assert_close(y1[:5], y0[:5])
        torch.testing.assert_close(stale[1], zero[1])
