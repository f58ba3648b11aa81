"""Shared harness of the recurrent families' parity tests
(tests/test_torch_mamba.py, test_torch_hybrid.py,
test_torch_linear_attention.py): a seeded float32 ``transformers`` model,
the JAX and port models on its checkpoint, three ragged steps through
both, and greedy tokens of the JAX model against the port's ``LLM``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

ATOL = 2e-4
PS, PAGES, SLOTS = 16, 8, 3


def random_hf(cfg, hf_cls, seed=0):
    """A seeded float32 ``transformers`` model with its norm weights and
    biases redrawn (so that the tests see them)."""
    torch.manual_seed(seed)
    model = hf_cls(cfg).float().eval()
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias") and "dt_bias" not in name \
                    and "conv1d" not in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
            elif "norm" in name and p.dim() == 1:
                p.copy_(p + torch.randn(p.shape, generator=gen) * 0.1)
    return model


def state_dict(hf):
    return {k: v.detach().float().numpy().copy()
            for k, v in hf.state_dict().items()}


def models(cfg, sd):
    """(JAX model, its params, port model, port params from the
    checkpoint), float32 on the CPU."""
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu_torch.models import ModelConfig as TConfig
    from tensorrt_llm_tpu_torch.models import get_model_class as tget
    jm = jget(cfg.model_type)(JConfig(hf_config=cfg, dtype=jnp.float32))
    jm._num_slots = SLOTS
    tm = tget(cfg.model_type)(TConfig(hf_config=cfg, dtype=torch.float32,
                                      device="cpu"))
    return jm, jm.load_hf_state_dict(dict(sd)), tm, \
        tm.load_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})


@dataclasses.dataclass
class Step:
    """One ragged step: per row its tokens, first position, slot and
    pages."""
    toks: list
    starts: list
    slots: list
    pages: list

    def arrays(self):
        lens = [len(t) for t in self.toks]
        S = len(lens)
        cu = np.zeros(S + 1, np.int32)
        cu[1:] = np.cumsum(lens)
        pos = np.concatenate([np.arange(s, s + n) for s, n in
                              zip(self.starts, lens)]).astype(np.int32)
        seq = np.repeat(np.arange(S), lens)
        table = np.zeros((S, PAGES), np.int32)
        for i, p in enumerate(self.pages):
            table[i, :len(p)] = p
        slots = (table[seq, pos // PS] * PS + pos % PS).astype(np.int32)
        return dict(
            tokens=np.concatenate(self.toks).astype(np.int32),
            kv_lens=np.asarray([s + n for s, n in zip(self.starts, lens)],
                               np.int32),
            page_indices=table, cu_q_lens=cu,
            num_seqs=np.asarray([S], np.int32), slot_mapping=slots,
            positions=pos, logits_indices=(cu[1:] - 1).astype(np.int32),
            seq_slots=np.asarray(self.slots, np.int32),
            max_q_len=max(lens))

    def jax(self, jm, params, pool, forward=None):
        from tensorrt_llm_tpu.ops.attention import AttentionMetadata
        a = self.arrays()
        md = AttentionMetadata(**{k: jnp.asarray(a[k]) for k in (
            "kv_lens", "page_indices", "cu_q_lens", "num_seqs",
            "slot_mapping", "positions", "logits_indices", "seq_slots")})
        logits, pool = (forward or jm.forward)(
            params, jnp.asarray(a["tokens"]), pool, md)
        return np.asarray(logits), pool

    def port(self, tm, params, pool):
        from tensorrt_llm_tpu_torch.ops.attention import AttentionMetadata
        a = self.arrays()
        t = torch.from_numpy
        md = AttentionMetadata(
            **{k: t(a[k]) for k in (
                "kv_lens", "page_indices", "cu_q_lens", "num_seqs",
                "slot_mapping", "positions", "seq_slots")},
            logits_indices=t(a["logits_indices"]).long(),
            max_q_len=a["max_q_len"], max_kv_len=int(a["kv_lens"].max()))
        logits, pool = tm.forward(params, t(a["tokens"]).long(), pool, md)
        return logits.numpy(), pool


def three_steps(jm, jparams, tm, tparams, vocab):
    """Both models through three steps on fresh pools: prompts of 11 and
    7 tokens (slots 2 and 0), then a decode row beside a 5-token segment
    that continues the second prompt, then two decode rows. Returns the
    JAX and port logits of each step and both final pools."""
    rng = np.random.default_rng(0)
    r = lambda n: list(rng.integers(0, vocab, size=n))
    pages = [[0, 1], [2, 3]]
    steps = [Step([r(11), r(7)], [0, 0], [2, 0], pages),
             Step([r(1), r(5)], [11, 7], [2, 0], pages),
             Step([r(1), r(1)], [12, 12], [2, 0], pages)]
    jpool = jm.make_kv_pages(PAGES, PS)
    tpool = tm.make_kv_pages(PAGES, PS, num_slots=SLOTS + 1)
    want, got = [], []
    for st in steps:
        jl, jpool = st.jax(jm, jparams, jpool, _jitted(jm))
        tl, tpool = st.port(tm, tparams, tpool)
        want.append(jl)
        got.append(tl)
    return want, got, jpool, tpool


def check_three_steps(jm, jparams, tm, tparams, vocab, state_view=None):
    """``three_steps``' logits agree within ATOL, and so do the slots'
    states (``state_view(name, jax pool array)`` reshapes a JAX pool to
    the port's [layers, slots, ...])."""
    want, got, jpool, tpool = three_steps(jm, jparams, tm, tparams, vocab)
    for w, g in zip(want, got):
        assert np.abs(w).max() > 0.01
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)
    for name, pool in tpool.items():
        if name == "kv":
            continue
        j = np.asarray(jpool[name])
        if state_view is not None:
            j = state_view(name, j)
        np.testing.assert_allclose(pool[:, :SLOTS].numpy(), j, atol=ATOL,
                                   rtol=0)


def jax_greedy(jm, jparams, prompt, n):
    """n greedy tokens of the JAX model from one prompt in slot 0 (a
    prefill step, then decode steps), its forward jitted."""
    fwd = _jitted(jm)
    pool = jm.make_kv_pages(PAGES, PS)
    pages = [list(range(PAGES))]
    logits, pool = Step([list(prompt)], [0], [0], pages).jax(
        jm, jparams, pool, fwd)
    out = [int(np.argmax(logits[0]))]
    while len(out) < n:
        logits, pool = Step([[out[-1]]], [len(prompt) + len(out) - 1], [0],
                            pages).jax(jm, jparams, pool, fwd)
        out.append(int(np.argmax(logits[0])))
    return out


def _jitted(jm):
    if not hasattr(jm, "_test_jit"):
        jm._test_jit = jax.jit(jm.forward)
    return jm._test_jit


def port_llm(hf_model, **kw):
    from tensorrt_llm_tpu_torch import LLM, KvCacheConfig
    args = dict(skip_tokenizer_init=True, dtype="float32", device="cpu",
                max_batch_size=4, max_input_len=32, max_seq_len=64,
                max_num_tokens=128,
                kv_cache_config=KvCacheConfig(tokens_per_block=PS,
                                              max_tokens=512))
    args.update(kw)
    return LLM(model=hf_model, **args)


def greedy(n):
    from tensorrt_llm_tpu_torch import SamplingParams
    return SamplingParams(max_tokens=n, top_k=1, end_id=-1)


def check_llm_matches_jax(jm, jparams, hf_model, prompts, n=6, **kw):
    """The port ``LLM``'s greedy tokens on ``prompts`` (one batch) equal
    the JAX model's, prompt by prompt."""
    llm = port_llm(hf_model, **kw)
    try:
        outs = llm.generate(prompts, greedy(n))
    finally:
        llm.shutdown()
    for p, o in zip(prompts, outs):
        assert o.outputs[0].token_ids == jax_greedy(jm, jparams, p, n)


def jax_tree_np(params):
    return jax.tree.map(np.asarray, params)
