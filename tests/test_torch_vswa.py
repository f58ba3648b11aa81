"""VSWA on the port: Gemma 2's sliding layers on a KV pool of their own,
the counterparts of tests/test_vswa.py, on the CPU in float32.

The fixture is tests/test_vswa.py's tiny Gemma 2 (window 16, page 8),
saved to a temporary directory. Greedy streams of the port's ``LLM``
with VSWA equal those of its single pool, of transformers' own greedy
decoding, and of the JAX ``LLM`` with the same arguments on single
requests. The concurrent batch of four prompts must equal transformers
on every stream: the JAX package releases sliding blocks at admission by
the prompt's end, before the prefill that still reads them, and its
stream 0 parts from transformers there, so the port is compared with
JAX only one request at a time. Also: the two pools, blocks released
while a sequence runs and all returned at its end, the release rule
itself (``VswaKvManager``), the K-step window under VSWA, no rider
window under VSWA, and one W4A16 Gemma 2 against the JAX ``LLM``.
"""
import pytest
import torch

from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import (KVCacheManager,
                                                             VswaKvManager)
from tensorrt_llm_tpu_torch.runtime.request import LlmRequest

PROMPT = list(range(2, 40))          # 38 tokens >> window 16
CONCURRENT = [list(range(3 + i, 30 + i)) for i in range(4)]


@pytest.fixture(scope="module")
def gemma2(tmp_path_factory):
    from transformers import Gemma2Config, Gemma2ForCausalLM
    torch.manual_seed(0)
    cfg = Gemma2Config(vocab_size=128, hidden_size=64,
                       intermediate_size=128, num_hidden_layers=4,
                       num_attention_heads=4, num_key_value_heads=2,
                       head_dim=16, query_pre_attn_scalar=16,
                       sliding_window=16, max_position_embeddings=256,
                       attn_logit_softcapping=50.0,
                       final_logit_softcapping=30.0)
    model = Gemma2ForCausalLM(cfg).eval()
    path = tmp_path_factory.mktemp("gemma2")
    model.save_pretrained(path, safe_serialization=True)
    return model, path


def _hf_greedy(model, prompt, n):
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            ids.append(int(torch.argmax(model(torch.tensor([ids])).logits[
                0, -1])))
    return ids[len(prompt):]


def _llm(path, vswa: bool, pkg="torch", **kw):
    if pkg == "torch":
        from tensorrt_llm_tpu_torch import LLM, KvCacheConfig
        kw["device"] = "cpu"
    else:
        from tensorrt_llm_tpu import LLM, KvCacheConfig
    kv = dict(tokens_per_block=8, max_tokens=2048)
    if vswa:
        kv["max_attention_window"] = [16, 128]
    args = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
                max_input_len=64, max_seq_len=128, max_num_tokens=256)
    args.update(kw)
    return LLM(model=str(path), kv_cache_config=KvCacheConfig(**kv), **args)


def _sp(n, pkg="torch"):
    if pkg == "torch":
        from tensorrt_llm_tpu_torch import SamplingParams
    else:
        from tensorrt_llm_tpu import SamplingParams
    return SamplingParams(max_tokens=n, top_k=1, end_id=-1)


@pytest.mark.parametrize("vswa", [False, True], ids=["single", "vswa"])
def test_matches_hf_and_jax_llm(gemma2, vswa):
    """One request past the window: the port equals transformers and the
    JAX ``LLM`` with the same arguments, with one pool and with two."""
    model, path = gemma2
    hf = _hf_greedy(model, PROMPT, 12)
    out = {}
    for pkg in ("torch", "jax"):
        llm = _llm(path, vswa, pkg)
        try:
            out[pkg] = llm.generate(PROMPT, _sp(12, pkg)).outputs[0].token_ids
        finally:
            llm.shutdown()
    assert out["torch"] == hf
    assert out["jax"] == hf


def test_two_pools_sliding_smaller(gemma2):
    _, path = gemma2
    llm = _llm(path, vswa=True)
    try:
        eng = llm.engine
        assert eng._vswa and eng.model.vswa_window == 16
        kv_g, kv_s = eng.kv_pages
        assert kv_g.shape[0] == kv_s.shape[0] == 2       # 2 layers each
        assert kv_s.shape[1] == eng.num_sw_pages < kv_g.shape[1]
        assert kv_g.shape[2:] == kv_s.shape[2:] == (8, 4, 16)
        assert isinstance(llm.kv_cache_manager, VswaKvManager)
        assert llm.kv_cache_manager.s.num_blocks == eng.num_sw_pages
        # the engine's bytes per page count the global pool's 2 layers
        assert eng.bytes_per_kv_block == 2 * 8 * 4 * 16 * 4
    finally:
        llm.shutdown()


def test_trimmed_blocks_return_to_the_free_list(gemma2):
    """48 prompt + 30 generated tokens with window 16 and page 8: sliding
    blocks are released while the sequence runs (it never holds more
    than the window's pages plus the K-step window's), and every block is
    free again at its end."""
    _, path = gemma2
    llm = _llm(path, vswa=True)
    mgr = llm.kv_cache_manager
    free0 = mgr.s.get_num_free_blocks()
    held = []
    grow = mgr.s.add_tokens

    def spy(req, n):
        grow(req, n)
        held.append(sum(1 for b in mgr.s._seq_blocks[req.request_id]
                        if type(b).__name__ != "_TrimmedBlock"))
    mgr.s.add_tokens = spy
    try:
        out = llm.generate(list(range(2, 50)), _sp(30))
        assert len(out.outputs[0].token_ids) == 30
    finally:
        llm.shutdown()
    assert mgr.trimmed_blocks >= 5
    assert held and max(held) <= -(-(16 + 8) // 8) + 2
    assert mgr.s.get_num_free_blocks() == free0
    assert mgr.g.get_num_free_blocks() == mgr.g.num_blocks


def test_concurrent_batch_equals_hf(gemma2):
    """Four prompts admitted together, ten greedy tokens each: every
    stream equals transformers (the JAX package's stream 0 does not,
    module docstring)."""
    model, path = gemma2
    llm = _llm(path, vswa=True)
    try:
        outs = [o.outputs[0].token_ids
                for o in llm.generate(CONCURRENT, _sp(10))]
        again = [o.outputs[0].token_ids
                 for o in llm.generate(CONCURRENT, _sp(10))]
        trimmed = llm.kv_cache_manager.trimmed_blocks
    finally:
        llm.shutdown()
    for prompt, got in zip(CONCURRENT, outs):
        assert got == _hf_greedy(model, prompt, 10)
    assert again == outs
    assert trimmed > 0


def test_multi_step_window_active(gemma2):
    """The K-step decode window addresses both pools, so VSWA keeps it:
    windows run and the output equals transformers."""
    model, path = gemma2
    llm = _llm(path, vswa=True)
    try:
        assert llm.args.decode_multi_step > 1
        out = llm.generate(PROMPT, _sp(13)).outputs[0].token_ids
        keys = list(llm.engine.graphs.steps)
        window_steps = llm.engine.window_steps
    finally:
        llm.shutdown()
    assert any(k[0] == "multi" for k in keys), keys
    assert window_steps > 0
    assert out == _hf_greedy(model, PROMPT, 13)


@pytest.mark.parametrize("vswa", [False, True], ids=["single", "vswa"])
def test_no_rider_window_under_vswa(gemma2, vswa):
    """``mixed_window_ctx`` > 0: context rides in decode windows with one
    pool, never with two (as the JAX executor's ``_mixed_ok``)."""
    model, path = gemma2
    llm = _llm(path, vswa, mixed_window_ctx=64, max_num_tokens=64)
    try:
        assert llm.executor._mixed_ok() == (not vswa)
        first = llm.generate_async(PROMPT, _sp(24))
        rest = [llm.generate_async(p, _sp(6)) for p in CONCURRENT[:3]]
        outs = [first.result(120)] + [r.result(120) for r in rest]
        dispatched = llm.engine.mixed_windows_dispatched
    finally:
        llm.shutdown()
    if vswa:
        assert dispatched == 0
    got = [o.outputs[0].token_ids for o in outs]
    want = [_hf_greedy(model, p, n)
            for p, n in zip([PROMPT] + CONCURRENT[:3], [24, 6, 6, 6])]
    assert got == want


def _req(rid, n_prompt):
    r = LlmRequest(prompt_token_ids=list(range(1, n_prompt + 1)),
                   request_id=rid)
    return r


def test_release_rule_keeps_every_visible_block():
    """The facade releases a sliding block only once no query still to be
    computed can see it: nothing at admission (the prefill still reads
    the prompt's early keys), and before a step whose first query sits
    at position q only the blocks wholly below q - window + 1."""
    window, ps = 16, 8
    mgr = VswaKvManager(KVCacheManager(64, ps, enable_block_reuse=False),
                        KVCacheManager(64, ps, enable_block_reuse=False,
                                       ids_attr="kv_block_ids_sw"),
                        window)
    a = _req(1, 40)
    mgr.add_sequence(a)
    assert mgr.trimmed_blocks == 0
    assert len(a.kv_block_ids_sw) == 5
    assert a.kv_block_ids == [blk.block_id                 # global untouched
                              for blk in mgr.g._seq_blocks[a.request_id]]
    free_after_admission = mgr.s.get_num_free_blocks()
    b = _req(2, 40)                                  # admitted in the same step
    mgr.add_sequence(b)
    assert not set(a.kv_block_ids_sw) & set(b.kv_block_ids_sw)
    for q in range(40, 60):                          # decode steps of a
        a.num_device_tokens = q
        mgr.add_token(a)
        first_visible = q - window + 1
        chain = mgr.s._seq_blocks[a.request_id]
        for i, blk in enumerate(chain):
            released = type(blk).__name__ == "_TrimmedBlock"
            assert released == ((i + 1) * ps <= first_visible), (q, i)
        assert a.kv_block_ids_sw[:len(chain)] == [blk.block_id
                                                  for blk in chain]
    assert mgr.s.get_num_free_blocks() > free_after_admission - 5
    mgr.free_resources(a)
    mgr.free_resources(b)
    assert mgr.s.get_num_free_blocks() == 64
    assert mgr.g.get_num_free_blocks() == 64


def test_admission_rolls_back_when_the_sliding_pool_is_full():
    """A sliding pool too small for the prompt: admission raises and the
    global blocks go back."""
    from tensorrt_llm_tpu_torch.runtime.kv_cache_manager import \
        NoFreeBlocksError
    mgr = VswaKvManager(KVCacheManager(64, 8, enable_block_reuse=False),
                        KVCacheManager(3, 8, enable_block_reuse=False,
                                       ids_attr="kv_block_ids_sw"), 16)
    with pytest.raises(NoFreeBlocksError):
        mgr.add_sequence(_req(3, 40))
    assert mgr.g.get_num_free_blocks() == 64
    assert mgr.s.get_num_free_blocks() == 3


def test_w4a16_gemma2_matches_jax(tmp_path, monkeypatch):
    """A seeded Gemma 2 whose widths fit the dequant-matmul kernel (hidden
    256, intermediate 512, group 64), W4A16_AWQ, one pool (two prompts
    in one batch: module docstring), greedy through both ``LLM``s (the
    JAX side's kernel in interpret mode): identical
    tokens wherever JAX decides by more than 3e-2 in log-probability (the
    kernel route rounds each projection to bf16, and a random-weight
    model has near-ties; tests/test_torch_quant_model.py)."""
    from transformers import Gemma2Config, Gemma2ForCausalLM
    monkeypatch.setenv("TLLM_TPU_PALLAS_INTERPRET", "1")
    torch.manual_seed(5)
    cfg = Gemma2Config(vocab_size=256, hidden_size=256,
                       intermediate_size=512, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=2,
                       head_dim=64, query_pre_attn_scalar=64,
                       sliding_window=16, max_position_embeddings=256)
    Gemma2ForCausalLM(cfg).eval().save_pretrained(tmp_path)
    prompts = [list(range(2, 40)), list(range(7, 30))]
    out = {}
    for pkg in ("torch", "jax"):
        if pkg == "torch":
            from tensorrt_llm_tpu_torch import QuantAlgo, QuantConfig
        else:
            from tensorrt_llm_tpu import QuantAlgo, QuantConfig
        llm = _llm(tmp_path, False, pkg, quant_config=QuantConfig(
            quant_algo=QuantAlgo.W4A16_AWQ, group_size=64))
        try:
            sp = _sp(12, pkg)
            sp.logprobs = 2
            res = llm.generate(prompts, sp)
        finally:
            llm.shutdown()
        out[pkg] = [(r.outputs[0].token_ids, r.outputs[0].logprobs)
                    for r in res]
    agreed = 0
    for (ref, lps), (got, _) in zip(out["jax"], out["torch"]):
        assert len(got) == 12
        for a, b, lp in zip(ref, got, lps):
            if a != b:
                top = sorted(lp.values(), reverse=True)
                assert top[0] - top[1] <= 3e-2, (ref, got, lp)
                break
            agreed += 1
    assert agreed >= 12
