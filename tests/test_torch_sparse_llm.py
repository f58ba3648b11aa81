"""ROCKET_TOPK and DSA sparse decode end to end on the CPU: the port's
``LLM`` against the JAX ``LLM`` on tests/assets/tinycode-llama in
float32, contexts of 7-12 pages against ``keep_pages`` = 4, at K = 8
windows and K = 1 single steps. Then the steps that the JAX engine runs
dense under a sparse config: a decode step whose token bucket is not the
row count, a rider window's decode rows."""
from pathlib import Path

import numpy as np
import pytest

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu.llmapi.llm_args import SparseAttentionConfig as JSac
from tensorrt_llm_tpu.ops import sparse_attention as jsa

CKPT = str(Path(__file__).resolve().parent / "assets" / "tinycode-llama")
PAGE = 16


def _prompts(lens=(90, 130, 161), seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(1, 255, n).tolist() for n in lens]


def _kw(K, **extra):
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=256, max_seq_len=320, max_num_tokens=512,
              decode_multi_step=K)
    kw.update(extra)
    return kw


def _run(pkg, algo, K, prompts, n=24, **extra):
    """(greedy tokens, the LLM's engine) of one LLM built and shut."""
    kw = _kw(K, **extra)
    if algo is not None:
        cfg = dict(algo=algo, keep_pages=4)
        kw["sparse_attention_config"] = JSac(**cfg) if pkg is J else \
            T.SparseAttentionConfig(**cfg)
    kv = pkg.KvCacheConfig(tokens_per_block=PAGE, max_tokens=4096)
    llm = pkg.LLM(model=CKPT, kv_cache_config=kv, **kw) if pkg is J else \
        T.LLM(CKPT, device="cpu", kv_cache_config=kv, **kw)
    try:
        outs = llm.generate(prompts, pkg.SamplingParams(
            max_tokens=n, top_k=1, ignore_eos=True))
        return [o.outputs[0].token_ids for o in outs], llm.engine
    finally:
        llm.shutdown()


@pytest.mark.parametrize("K", (8, 1))
@pytest.mark.parametrize("algo", ("ROCKET_TOPK", "DSA"))
def test_sparse_tokens_match_jax(algo, K):
    """Greedy tokens equal the JAX LLM's past the page budget; every
    decode step of the port took the sparse route (windows at K = 8,
    single steps whose bucket is the row count at K = 1)."""
    prompts = _prompts()
    ref, _ = _run(J, algo, K, prompts)
    got, eng = _run(T, algo, K, prompts)
    assert got == ref
    assert eng.sparse_steps == eng.decode_steps > 0


def test_sparse_moves_tokens_off_dense():
    """The budget is binding: keep_pages 4 of up to 12 pages changes the
    greedy tokens (so the equality above is not the dense path's)."""
    prompts = _prompts()
    sparse, _ = _run(T, "ROCKET_TOPK", 8, prompts)
    dense, eng = _run(T, None, 8, prompts)
    assert sparse != dense and eng.sparse_steps == 0


def test_bucket_below_row_count_runs_dense(monkeypatch):
    """A single decode step whose token bucket (8) is not the row count
    (16) fails the JAX static condition ``q.shape[0] ==
    kv_lens.shape[0]``: the JAX engine never traces its sparse path there
    and serves it dense (a reference gap, ROADMAP C), and so does the
    port; tokens equal the dense run's."""
    traced = []
    real = jsa.sparse_paged_decode_attention

    def spy(q, *a, **k):
        traced.append(q.shape)
        return real(q, *a, **k)

    monkeypatch.setattr(jsa, "sparse_paged_decode_attention", spy)
    prompts = _prompts((90, 130))
    extra = dict(max_batch_size=16,
                 bucketing_config=dict(token_buckets=[8, 512]))
    ref, _ = _run(J, "DSA", 1, prompts, n=8, **extra)
    assert traced == []
    got, eng = _run(T, "DSA", 1, prompts, n=8, **extra)
    dense, _ = _run(T, None, 1, prompts, n=8, **extra)
    assert got == ref == dense
    assert eng.decode_steps > 0 and eng.sparse_steps == 0


def test_rider_window_decode_rows_run_dense(monkeypatch):
    """A window with riders: the JAX mixed split attends its decode rows
    without the sparse settings (ops/attention.py:262-301, a reference
    gap), so the port's rider windows run them dense too: the key holds
    no sparse bound and the window counts no sparse step."""
    import jax.numpy as jnp
    from tensorrt_llm_tpu.ops import attention as ja
    calls = []
    monkeypatch.setattr(jsa, "sparse_paged_decode_attention",
                        lambda *a, **k: calls.append(1))
    S, P, hd = 2, 4, 16
    md = ja.AttentionMetadata(
        kv_lens=jnp.asarray([20, 30, 5], jnp.int32),
        page_indices=jnp.arange(3 * P, dtype=jnp.int32).reshape(3, P),
        cu_q_lens=jnp.asarray([0, 1, 2, 7], jnp.int32),
        num_seqs=jnp.asarray([3], jnp.int32),
        slot_mapping=jnp.full((7,), 10 ** 6, jnp.int32),
        positions=jnp.zeros((7,), jnp.int32),
        logits_indices=jnp.arange(2, dtype=jnp.int32))
    pool = jnp.ones((3 * P, PAGE, 4, hd), jnp.float32)
    with ja.rpa_mixed_split(S):
        ja.ragged_paged_attention(jnp.ones((7, 4, hd), jnp.float32), pool,
                                  md, sm_scale=0.25, sparse_keep_pages=1)
    assert calls == []
    llm = T.LLM(CKPT, device="cpu", kv_cache_config=T.KvCacheConfig(
        tokens_per_block=PAGE, max_tokens=4096),
        sparse_attention_config=T.SparseAttentionConfig(keep_pages=4),
        **_kw(4, mixed_window_ctx=32))
    try:
        eng = llm.engine
        assert eng.riders_ok
        assert "sparse" not in eng._window_key(4, 4, 32, 256, True, False)
        assert eng._window_key(4, 4, 0, 256, True, False)[-2:] == \
            ("sparse", 256)
    finally:
        llm.shutdown()


def test_passkey_accuracy_matches_jax():
    """Passkey retrieval on the trained tests/assets/tinypasskey-llama at
    250 tokens over pages of 16, 8 of its 16 pages kept: the port's
    per-depth accuracy equals the JAX LLM's under each indexer (the
    pooled-key ROCKET_TOPK loses every key there, DSA keeps most: the
    JAX design, read as it is)."""
    from tensorrt_llm_tpu.evaluate.tasks import PasskeyRetrieval as JPass
    from tensorrt_llm_tpu_torch.evaluate.tasks import PasskeyRetrieval
    ckpt = str(Path(CKPT).parent / "tinypasskey-llama")
    kw = dict(dtype="float32", skip_tokenizer_init=True, max_batch_size=16,
              max_input_len=314, max_seq_len=346, max_num_tokens=8192)
    task = dict(context_len=250, depths=(0.15, 0.35, 0.55, 0.75, 0.9),
                num_keys=2, style="marker")
    for algo in ("ROCKET_TOPK", "DSA"):
        cfg = dict(algo=algo, keep_pages=8)
        jllm = J.LLM(model=ckpt, sparse_attention_config=JSac(**cfg),
                     kv_cache_config=J.KvCacheConfig(
                         tokens_per_block=PAGE, enable_block_reuse=False),
                     **kw)
        ref = JPass(**task).evaluate(jllm)["per_depth"]
        jllm.shutdown()
        llm = T.LLM(ckpt, device="cpu",
                    sparse_attention_config=T.SparseAttentionConfig(**cfg),
                    kv_cache_config=T.KvCacheConfig(
                        tokens_per_block=PAGE, enable_block_reuse=False),
                    **kw)
        got = PasskeyRetrieval(**task).evaluate(llm)["per_depth"]
        assert llm.engine.sparse_steps > 0
        llm.shutdown()
        assert got == ref, (algo, got, ref)
