"""STAR prefill end to end on the CPU: the port's ``LLM`` against the
JAX ``LLM`` on tests/assets/tinycode-llama in float32, prompts of 90-161
tokens against 32-token blocks (past two blocks, so STAR is not causal
attention), in one prefill step and in 48-token chunks that cross block
edges, at K = 8 and K = 1; a block that is not a whole number of pages
takes the plain STAR route, and a model with a sliding window the remap
with its windowed launches. Then the
sparse config on the types whose JAX forward drops it (refused here by
name)."""
from pathlib import Path

import numpy as np
import pytest

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu.llmapi.llm_args import SparseAttentionConfig as JSac

CKPT = str(Path(__file__).resolve().parent / "assets" / "tinycode-llama")
PAGE = 16


def _prompts(lens=(90, 130, 161), seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(1, 255, n).tolist() for n in lens]


def _run(pkg, block, K, prompts, n=16, model=CKPT, **extra):
    """(greedy tokens, the LLM's engine) of one LLM built and shut."""
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=256, max_seq_len=320, max_num_tokens=512,
              decode_multi_step=K)
    kw.update(extra)
    if block is not None:
        cfg = dict(algo="STAR", star_block_size=block)
        kw["sparse_attention_config"] = JSac(**cfg) if pkg is J else \
            T.SparseAttentionConfig(**cfg)
    kv = pkg.KvCacheConfig(tokens_per_block=PAGE, max_tokens=4096)
    llm = pkg.LLM(model=model, kv_cache_config=kv, **kw) if pkg is J else \
        T.LLM(model, device="cpu", kv_cache_config=kv, **kw)
    try:
        outs = llm.generate(prompts, pkg.SamplingParams(
            max_tokens=n, top_k=1, ignore_eos=True))
        return [o.outputs[0].token_ids for o in outs], llm.engine
    finally:
        llm.shutdown()


@pytest.mark.parametrize("K,chunk", ((8, 512), (1, 48)))
def test_star_tokens_match_jax(K, chunk):
    """Greedy tokens equal the JAX LLM's; every prompt step of the port
    went through the virtual-sequence remap (48-token chunks cross the
    32-token block edges), decode steps stayed dense, and STAR moved the
    tokens off the causal run's."""
    prompts = _prompts()
    ref, _ = _run(J, 32, K, prompts, max_num_tokens=chunk)
    got, eng = _run(T, 32, K, prompts, max_num_tokens=chunk)
    assert got == ref
    assert eng.star_steps > 0 and eng.star_plain_steps == 0
    assert eng.sparse_steps == 0 and not eng.riders_ok
    if K == 8:
        causal, _ = _run(T, None, K, prompts, max_num_tokens=chunk)
        assert got != causal


def test_star_plain_route_matches_jax():
    """A 24-token block over 16-token pages has no page-aligned remap:
    the engine counts its prompt steps on the plain STAR reference, and
    the tokens equal the JAX LLM's."""
    prompts = _prompts((90, 130))
    ref, _ = _run(J, 24, 8, prompts, n=8)
    got, eng = _run(T, 24, 8, prompts, n=8)
    assert got == ref
    assert eng.star_plain_steps > 0 and eng.star_steps == 0


@pytest.mark.parametrize("chunk", (512, 48))
def test_star_sliding_window_through_the_remap(chunk):
    """A model with a sliding window (a tiny Mistral, window 40) under
    STAR at blocks of 32, in one prefill step and in 48-token chunks:
    rows of block 2 before position 72 see block 0 through a window
    shortened by a block, later rows their own block alone; every prompt
    step goes through the remap, and the tokens equal the JAX LLM's
    (prompts reach block 4, where the window drops all of block 0)."""
    model = _tiny("mistral")
    prompts = [[t % 127 + 1 for t in p] for p in _prompts((150, 100))]
    ref, _ = _run(J, 32, 8, prompts, n=8, model=model,
                  max_num_tokens=chunk)
    got, eng = _run(T, 32, 8, prompts, n=8, model=model,
                    max_num_tokens=chunk)
    assert got == ref
    assert eng.star_steps > 0 and eng.star_plain_steps == 0


def _tiny(kind):
    import torch
    import transformers as tf
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=512)
    cfg, cls = {
        "mixtral": (tf.MixtralConfig(num_local_experts=4,
                                     num_experts_per_tok=2, **base),
                    tf.MixtralForCausalLM),
        "gemma2": (tf.Gemma2Config(head_dim=16, sliding_window=4096,
                                   **base), tf.Gemma2ForCausalLM),
        "mistral": (tf.MistralConfig(sliding_window=40, **base),
                    tf.MistralForCausalLM)}[kind]
    torch.manual_seed(0)
    return cls(cfg).float().eval()


@pytest.mark.parametrize("kind", ("mixtral", "gemma2"))
def test_dropping_types_refused(kind):
    """The JAX LLM takes a sparse config on a type whose forward does
    not pass it to attention and serves that type dense (tokens equal to
    its dense run past the budget); the port refuses it by name."""
    model = _tiny(kind)
    prompts = _prompts((70, 100), seed=1)
    prompts = [[t % 127 + 1 for t in p] for p in prompts]
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=128, max_seq_len=160, max_num_tokens=256,
              kv_cache_config=J.KvCacheConfig(tokens_per_block=PAGE,
                                              max_tokens=2048))
    sp = J.SamplingParams(max_tokens=8, top_k=1, ignore_eos=True)
    outs = {}
    for name, extra in (("dense", {}), ("sparse", dict(
            sparse_attention_config=JSac(algo="DSA", keep_pages=2)))):
        llm = J.LLM(model=model, **kw, **extra)
        outs[name] = [o.outputs[0].token_ids
                      for o in llm.generate(prompts, sp)]
        llm.shutdown()
    assert outs["sparse"] == outs["dense"]
    with pytest.raises(NotImplementedError, match=kind):
        T.LLM(model, device="cpu",
              sparse_attention_config=T.SparseAttentionConfig(
                  algo="STAR"), skip_tokenizer_init=True, dtype="float32")


def test_served_and_refused_types():
    """Every type the port registers is either served (the Llama trunk's
    types, whose JAX forward passes the settings) or refused by name;
    speculation beside a sparse config is refused too."""
    from tensorrt_llm_tpu_torch.llmapi.llm_args import (
        SPARSE_MODEL_TYPES, LlmArgs, check_sparse_served)
    from tensorrt_llm_tpu_torch.models.modeling_utils import MODEL_REGISTRY
    args = LlmArgs(model="x", sparse_attention_config=dict(algo="DSA"))
    for t in MODEL_REGISTRY:
        if t in SPARSE_MODEL_TYPES:
            check_sparse_served(args, t)
        else:
            with pytest.raises(NotImplementedError, match=t):
                check_sparse_served(args, t)
    args = LlmArgs(model="x", sparse_attention_config=dict(algo="STAR"),
                   speculative_config=dict(mode="NGRAM", max_draft_len=2))
    with pytest.raises(NotImplementedError, match="NGRAM"):
        check_sparse_served(args, "llama")


def test_jax_rider_chunks_drop_the_star_mask():
    """The JAX mixed split attends a rider window's context chunk with the
    plain causal reference, without the STAR mask (ops/attention.py:
    262-301, a reference gap, ROADMAP C): the port keeps riders off under
    STAR, so every prompt chunk gets the mask."""
    import jax.numpy as jnp
    from tensorrt_llm_tpu.ops import attention as ja
    r = np.random.default_rng(3)
    kvh, qh, hd, ps, P = 2, 4, 16, 16, 8
    pool = jnp.asarray(r.standard_normal((2 * P, ps, 2 * kvh, hd)),
                       jnp.float32)
    # row 0 a decode row at 40, then a 9-token chunk at 36-44 (block 2)
    md = ja.AttentionMetadata(
        kv_lens=jnp.asarray([41, 45], jnp.int32),
        page_indices=jnp.arange(2 * P, dtype=jnp.int32).reshape(2, P),
        cu_q_lens=jnp.asarray([0, 1, 10], jnp.int32),
        num_seqs=jnp.asarray([2], jnp.int32),
        slot_mapping=jnp.full((10,), 10 ** 6, jnp.int32),
        positions=jnp.asarray([40] + list(range(36, 45)), jnp.int32),
        logits_indices=jnp.arange(2, dtype=jnp.int32))
    q = jnp.asarray(r.standard_normal((10, qh, hd)), jnp.float32)
    kw = dict(sm_scale=0.25, backend="reference")
    with ja.rpa_mixed_split(1):
        rider = np.asarray(ja.ragged_paged_attention(
            q, pool, md, star_block_size=16, **kw))
    causal = np.asarray(ja.ragged_paged_attention(q, pool, md, **kw))
    star = np.asarray(ja.ragged_paged_attention(q, pool, md,
                                                star_block_size=16, **kw))
    np.testing.assert_allclose(rider, causal, rtol=1e-5, atol=1e-5)
    assert not np.allclose(rider[1:], star[1:], atol=1e-3)
    llm = T.LLM(CKPT, device="cpu", mixed_window_ctx=32,
                sparse_attention_config=T.SparseAttentionConfig(
                    algo="STAR", star_block_size=32),
                skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
                max_input_len=256, max_seq_len=320)
    assert not llm.engine.riders_ok
    llm.shutdown()
