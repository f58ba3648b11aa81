"""Multi-adapter LoRA in the port (tensorrt_llm_tpu_torch/lora/, the Llama
trunk's hooks, the engine's adapter stacks and slots) against the JAX
package and transformers on the CPU, float32, the tiny Llama of
tests/test_lora.py:

- the counterparts of tests/test_lora.py (an adapter against its weights
  folded into the base, isolation of base rows and of two adapters, DoRA
  against the merged weight, raw DoRA magnitudes refused, the prompt
  table), each with greedy tokens equal to the JAX ``LLM``'s;
- an adapter on all seven modules, two adapters and base rows in one
  batch with K-step windows and riders on (the gates that keep LoRA rows
  out of windows and riders), a prompt-table request beside
  an adapter request, a PEFT directory written by ``peft`` (rsLoRA too)
  loaded through ``lora_request.lora_path``, and a W4A16 base, against
  the JAX ``LLM``;
- ``apply_lora`` against the per-token gather at 1e-5, and the step's
  tensors, which hold no per-token [T, K, r] or [T, r, N] gather;
- beam search, whose beams carry the adapter where the JAX beams drop it;
- the refusals: the types whose JAX forward fails (Gemma: TypeError) or
  drops the adapter (the Mixtral family and the image-group VLMs) or that
  the JAX package refuses at construction, and ``lora_request`` without
  ``enable_lora``.
"""
import copy

import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu.lora import lora_manager as jl
from tensorrt_llm_tpu_torch.lora import lora_manager as tl
from tests.test_lora import (dora_fold_and_run, fold_and_run,
                             make_adapter, make_dora_adapter)

PROMPT = [5, 9, 23, 44]
MODULES = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
           "v": "self_attn.v_proj", "o": "self_attn.o_proj",
           "gate": "mlp.gate_proj", "up": "mlp.up_proj",
           "down": "mlp.down_proj"}


def _kw(pkg, **extra):
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=64, max_seq_len=128, max_num_tokens=256,
              decode_multi_step=4, mixed_window_ctx=16, enable_lora=True,
              lora_config={"max_lora_rank": 8, "max_loras": 8},
              kv_cache_config=pkg.KvCacheConfig(tokens_per_block=16,
                                                max_tokens=1024))
    kw.update(extra)
    return kw


def _port_adapter(ad):
    """The port's ``LoraAdapter`` of a JAX one (numpy arrays both)."""
    return tl.LoraAdapter(ad.task_id, ad.rank, {
        m: {layer: tl.LoraLayerWeights(w.a, w.b, w.scale, w.mag,
                                       w.mag_is_raw)
            for layer, w in per.items()}
        for m, per in ad.weights.items()})


def _all_modules_adapter(task_id, cfg, seed, rank=4, scale=1.0):
    """A JAX ``LoraAdapter`` on q, k, v, o, gate, up and down."""
    rng = np.random.default_rng(seed)
    shapes = {m: (K, N) for m, (K, N) in _shapes(cfg).items()}
    return jl.LoraAdapter(task_id, rank, {
        m: {layer: jl.LoraLayerWeights(
            a=(rng.normal(size=(K, rank)) * 0.2).astype(np.float32),
            b=(rng.normal(size=(rank, N)) * 0.2).astype(np.float32),
            scale=scale) for layer in range(cfg.num_hidden_layers)}
        for m, (K, N) in shapes.items()})


def _shapes(cfg):
    H, I = cfg.hidden_size, cfg.intermediate_size
    hd = H // cfg.num_attention_heads
    nkv = cfg.num_key_value_heads * hd
    return {"q": (H, H), "k": (H, nkv), "v": (H, nkv), "o": (H, H),
            "gate": (H, I), "up": (H, I), "down": (I, H)}


def _fold_module(tmodel, adapter):
    """A copy of ``tmodel`` with every module's adapter folded in."""
    m = copy.deepcopy(tmodel)
    with torch.no_grad():
        for mod, per in adapter.weights.items():
            for layer, w in per.items():
                m.get_submodule(f"model.layers.{layer}.{MODULES[mod]}") \
                    .weight += torch.tensor((w.a @ w.b).T * w.scale)
    return m


def _fold_all(tmodel, adapter, prompt, n):
    """transformers' greedy tokens with every module's adapter folded
    into its weight."""
    m = _fold_module(tmodel, adapter)
    ids = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            ids.append(int(m(torch.tensor([ids])).logits[0, -1].argmax()))
    return ids[len(prompt):]


class _Pair:
    """One JAX and one port ``LLM`` over the same tiny Llama, LoRA on."""

    def __init__(self):
        from transformers import LlamaConfig, LlamaForCausalLM
        torch.manual_seed(0)
        self.cfg = LlamaConfig(vocab_size=96, hidden_size=64,
                               intermediate_size=128, num_hidden_layers=2,
                               num_attention_heads=4, num_key_value_heads=2,
                               max_position_embeddings=512)
        self.tmodel = LlamaForCausalLM(self.cfg).eval()
        self.j = J.LLM(model=self.tmodel, **_kw(J))
        self.t = T.LLM(self.tmodel, device="cpu", **_kw(T))

    def add(self, ad):
        """Activate JAX adapter ``ad`` in both ``LLM``s."""
        for llm, a in ((self.j, ad), (self.t, _port_adapter(ad))):
            llm.lora_manager.add_adapter(a)
            llm.lora_manager.activate(a.task_id)
            llm.engine.refresh_lora()

    def both(self, prompts, lora=None, n=6):
        """Greedy tokens of ``prompts`` (one adapter id or None each)
        through both ``LLM``s, every request queued at once."""
        out = []
        for llm, pkg, req in ((self.j, J, jl.LoraRequest),
                              (self.t, T, tl.LoraRequest)):
            futs = [llm.generate_async(
                p, pkg.SamplingParams(max_tokens=n, top_k=1, end_id=-1),
                lora_request=None if tid is None else req("x", tid, ""))
                for p, tid in zip(prompts, lora or [None] * len(prompts))]
            out.append([f.result(60).outputs[0].token_ids for f in futs])
        return out


@pytest.fixture(scope="module")
def pair():
    p = _Pair()
    yield p
    p.j.shutdown()
    p.t.shutdown()


def test_lora_matches_folded_weights_and_jax(pair):
    adapter = make_adapter(7, pair.cfg, scale=1.0, seed=1)
    pair.add(adapter)
    j, t = pair.both([PROMPT], [7])
    assert t == j
    assert t[0] == fold_and_run(pair.tmodel, pair.cfg, adapter, PROMPT, 6)


def test_all_seven_modules_match_folded_weights(pair):
    ad = _all_modules_adapter(8, pair.cfg, seed=4)
    pair.add(ad)
    j, t = pair.both([PROMPT, [3, 1, 4, 1, 5, 9, 2, 6]], [8, 8], n=8)
    assert t == j
    assert t[0] == _fold_all(pair.tmodel, ad, PROMPT, 8)


def test_lora_isolation(pair):
    """Base requests are unaffected by active adapters; two adapters give
    different outputs."""
    prompt = [3, 7, 11, 13]
    base = pair.both([prompt])
    for tid, seed in ((21, 2), (22, 3)):
        pair.add(make_adapter(tid, pair.cfg, scale=2.0, seed=seed))
    j, t = pair.both([prompt, prompt], [21, 22])
    assert t == j
    assert t[0] != t[1]
    assert pair.both([prompt]) == base


def test_two_adapters_and_base_rows_in_one_batch(pair):
    """Two adapters and base rows share every step; the base rows' tokens
    are the base model's, and all equal the JAX ``LLM``'s (LoRA rows take
    single steps, base rows alone could take windows)."""
    for tid, seed in ((21, 2), (22, 3)):
        if pair.t.lora_manager.slot_for(tid) < 0:
            pair.add(make_adapter(tid, pair.cfg, scale=2.0, seed=seed))
    prompts = [[3, 7, 11, 13], [2, 4, 6, 8, 10], [3, 7, 11, 13], [1, 2, 3]]
    ids = [21, None, 22, None]
    j, t = pair.both(prompts, ids, n=10)
    assert t == j
    alone = pair.both([prompts[1], prompts[3]], n=10)[1]
    assert [t[1], t[3]] == alone


def test_lora_rows_take_no_window(pair):
    """The JAX gates (executor.py:1198, :1221, :1400): a LoRA row takes
    no K-step window, a LoRA prompt rides no mixed window, a LoRA row
    enters no speculative window; and a window given one raises."""
    from tensorrt_llm_tpu_torch.runtime.request import LlmRequest
    from tensorrt_llm_tpu_torch.runtime.scheduler import ScheduledRequests
    ex = pair.t.executor
    sp = T.SamplingParams(max_tokens=4)
    lora, base = (LlmRequest([1, 2, 3], sp, lora_task_id=tid)
                  for tid in (7, None))
    for r in (lora, base):
        r.seq_slot, r.spec_seeded = 0, True
    assert ex._multi_rows_ok([base]) and not ex._multi_rows_ok([base, lora])
    assert ex._ctx_rider_ok(base) and not ex._ctx_rider_ok(lora)
    assert not ex._spec_row_ok(lora)
    with pytest.raises(ValueError, match="LoRA row"):
        pair.t.engine.forward_multi_step(
            ScheduledRequests(generation_requests=[lora]), 4)


def test_dora_matches_merged_weights(pair):
    base_sd = {k: v.detach().float().numpy()
               for k, v in pair.tmodel.state_dict().items()}
    adapter = make_dora_adapter(31, pair.cfg, base_sd, seed=6)
    raw = np.random.default_rng(6)
    raw_mags = {}
    H = pair.cfg.hidden_size
    for layer in range(pair.cfg.num_hidden_layers):
        raw.normal(size=(H, 4))
        raw.normal(size=(4, H))
        raw_mags[layer] = raw.uniform(0.5, 1.5, size=H).astype(np.float32)
    pair.add(adapter)
    assert pair.t.engine.lora_dora
    j, t = pair.both([PROMPT], [31])
    assert t == j
    assert t[0] == dora_fold_and_run(pair.tmodel, pair.cfg, adapter,
                                     raw_mags, PROMPT, 6)


def test_refresh_rewrites_only_the_changed_slots(pair):
    """``refresh_lora`` writes the slots whose adapter changed, in place
    (the stacks keep their addresses, which captured graphs read), and
    leaves them equal to the manager's whole rebuild (``device_stacks``);
    a slot given back is zeroed, the others keep their adapters."""
    eng, mgr = pair.t.engine, pair.t.lora_manager
    ptrs = {m: [t.data_ptr() for t in st]
            for m, st in eng.lora_stacks.items()}

    def equal_to_rebuild():
        want = mgr.device_stacks(eng.model.lora_module_shapes(),
                                 eng.model.dtype, eng.device)
        for m, st in eng.lora_stacks.items():
            for got, w in zip(st, want[m]):
                assert torch.equal(got, w), m

    pair.add(make_adapter(41, pair.cfg, scale=2.0, seed=9))
    slot = mgr.slot_for(41)
    others = [s for s, ad in enumerate(eng.lora_written)
              if ad is not None and s != slot]
    assert eng.lora_written[slot] is mgr.adapter_in(slot)
    equal_to_rebuild()
    kept = {s: eng.lora_stacks["q"].a[..., s * 8:(s + 1) * 8].clone()
            for s in others}
    mgr.deactivate(41)
    eng.refresh_lora()
    equal_to_rebuild()
    st = eng.lora_stacks["q"]
    assert eng.lora_written[slot] is None
    assert not st.a[..., slot * 8:(slot + 1) * 8].any()
    assert float(st.scale[slot]) == 0.0
    for s, a in kept.items():
        assert torch.equal(st.a[..., s * 8:(s + 1) * 8], a)
    assert {m: [t.data_ptr() for t in st]
            for m, st in eng.lora_stacks.items()} == ptrs
    pair.j.lora_manager.deactivate(41)
    pair.j.engine.refresh_lora()


def test_dora_raw_magnitude_rejected(pair):
    H = pair.cfg.hidden_size
    w = {"q": {0: tl.LoraLayerWeights(
        a=np.zeros((H, 2), np.float32), b=np.zeros((2, H), np.float32),
        scale=1.0, mag=np.ones(H, np.float32), mag_is_raw=True)}}
    pair.t.lora_manager.add_adapter(tl.LoraAdapter(41, 2, w))
    with pytest.raises(ValueError, match="unnormalized"):
        pair.t.lora_manager.activate(41)
    with pytest.raises(KeyError, match="unknown lora_task_id"):
        pair.t.lora_manager.activate(42)


def test_prompt_table_beside_an_adapter_request(pair):
    """Virtual token ids >= vocab take prompt-table rows; such a request
    and an adapter request run in one batch, each as it runs alone and as
    in the JAX ``LLM``."""
    rng = np.random.default_rng(11)
    V = pair.cfg.vocab_size
    table = rng.normal(size=(4, pair.cfg.hidden_size)).astype(np.float32) \
        * 0.5
    prompt = {"prompt_token_ids": [V, V + 1, 5, 9, V + 3, 23],
              "prompt_tuning_config": {"embedding_table": table}}
    if pair.t.lora_manager.slot_for(7) < 0:
        pair.add(make_adapter(7, pair.cfg, scale=1.0, seed=1))
    j, t = pair.both([prompt, PROMPT], [None, 7], n=5)
    assert t == j
    assert t[0] == pair.both([prompt], n=5)[1][0]
    assert t[1] == pair.both([PROMPT], [7], n=5)[1][0]


def test_prompt_table_out_of_range(pair):
    table = np.zeros((2, pair.cfg.hidden_size), np.float32)
    with pytest.raises(ValueError, match="outside the prompt table"):
        pair.t.generate({"prompt_token_ids": [pair.cfg.vocab_size + 3],
                         "prompt_tuning_config": {"embedding_table": table}},
                        T.SamplingParams(max_tokens=2, top_k=1, end_id=-1))


@pytest.mark.parametrize("rslora", [False, True], ids=["lora", "rslora"])
def test_peft_directory(pair, tmp_path, rslora):
    """An adapter saved by ``peft`` (all seven modules, seeded B) and
    loaded from ``lora_request.lora_path``: tokens equal the ``peft``
    model's greedy tokens and the JAX ``LLM``'s."""
    from peft import LoraConfig, get_peft_model
    torch.manual_seed(5 + rslora)
    pm = get_peft_model(copy.deepcopy(pair.tmodel), LoraConfig(
        r=4, lora_alpha=8, use_rslora=rslora,
        target_modules=[v.split(".")[1] for v in MODULES.values()]))
    with torch.no_grad():
        for name, p in pm.named_parameters():
            if "lora_B" in name:
                p.normal_(0, 0.2)
    pm.save_pretrained(tmp_path)
    tid = 51 + rslora
    j = pair.j.generate_async(PROMPT, J.SamplingParams(max_tokens=6, top_k=1),
                              lora_request=jl.LoraRequest(
                                  "p", tid, str(tmp_path))).result(60)
    t = pair.t.generate(PROMPT, T.SamplingParams(max_tokens=6, top_k=1),
                        lora_request=tl.LoraRequest("p", tid, str(tmp_path)))
    ids = list(PROMPT)
    with torch.no_grad():
        for _ in range(6):
            ids.append(int(pm(torch.tensor([ids])).logits[0, -1].argmax()))
    assert t.outputs[0].token_ids == j.outputs[0].token_ids == ids[4:]
    scale = pair.t.lora_manager._host_cache[tid].weights["q"][0].scale
    assert scale == pytest.approx(8 / 2 if rslora else 8 / 4)


@pytest.mark.parametrize("dora", [False, True], ids=["lora", "dora"])
def test_apply_lora_matches_the_per_token_gather(dora):
    g = torch.Generator().manual_seed(0)
    T_, K, N, n, r = 37, 48, 80, 3, 8
    x = torch.randn(T_, K, generator=g)
    base = torch.randn(T_, N, generator=g)
    a = torch.randn(K, n * r, generator=g) * 0.3
    b = torch.randn(n * r, N, generator=g) * 0.3
    scales = torch.tensor([0.5, 2.0, 1.25, 0.0])
    slots = torch.randint(-1, n, (T_,), generator=g, dtype=torch.int32)
    mag = torch.rand(n + 1, N, generator=g) + 0.5 if dora else None
    got = tl.apply_lora(x, base, a, b, scales, slots, mag)
    want = tl.apply_lora_gather(x, base, a, b, scales, slots, mag)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    none = slots < 0
    ref = base[none] if mag is None else base[none] * mag[n]
    torch.testing.assert_close(got[none], ref, atol=0, rtol=0)


def test_lora_step_holds_no_per_token_gather(pair):
    """Every tensor a LoRA prompt step and a LoRA decode step make (the
    latter through the graph runner's static buffers, run eagerly on the
    CPU, under its key with LoRA) is narrower than the JAX form's
    per-token gathers: none is [T, K, r] or [T, r, N]."""
    from torch.utils._python_dispatch import TorchDispatchMode
    shapes = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(t, torch.Tensor):
                    shapes.append(tuple(t.shape))
            return out

    if pair.t.lora_manager.slot_for(8) < 0:
        pair.add(_all_modules_adapter(8, pair.cfg, seed=4))
    from tensorrt_llm_tpu_torch.runtime.request import (LlmRequest,
                                                        LlmRequestState)
    from tensorrt_llm_tpu_torch.runtime.scheduler import ScheduledRequests
    eng = pair.t.engine
    req = LlmRequest(list(range(1, 41)),
                     T.SamplingParams(max_tokens=2, top_k=1),
                     lora_task_id=8)
    req.seq_slot = 0
    req.context_chunk_size = 40
    kv = pair.t.kv_cache_manager
    kv.add_sequence(req, enable_reuse=False)
    try:
        with Record():
            eng.forward_step(ScheduledRequests(context_requests=[req]))
        req.state = LlmRequestState.GENERATION_IN_PROGRESS
        req.num_device_tokens = 40
        req.host_token_override = 5
        kv.add_token(req)
        decode0 = len(shapes)
        with Record():
            eng.forward_step(ScheduledRequests(generation_requests=[req]))
    finally:
        kv.free_resources(req, store_for_reuse=False)
    assert len(shapes) > decode0
    assert any(k[0] == "step" and k[-2:] == ("lora", eng.lora_dora)
               for k in eng.graphs.steps)
    r = pair.t.lora_manager.config.max_lora_rank
    tok = 40
    mods = eng.model.lora_module_shapes().values()
    gathers = {(K, r) for K, _ in mods} | {(r, N) for _, N in mods}
    big = [s for s in shapes if len(s) == 3 and s[1:] in gathers]
    assert big == [], big
    # h = x @ A_cat over the step's bucket, every slot's columns
    assert (eng._pick_bucket(tok), 8 * r) in shapes


def test_beams_carry_the_adapter_where_jax_drops_it(pair):
    """Beam search with an adapter: the port's beams equal beam search on
    the weights with the adapter folded in; the JAX beam rows are built
    without the request's ``lora_task_id`` (runtime/beam_search.py:
    166-168), so its beams are the base model's (ROADMAP C)."""
    ad = _all_modules_adapter(12, pair.cfg, seed=12, scale=2.0)
    sp = dict(max_tokens=6, use_beam_search=True, best_of=2, n=1)
    out = {}
    for name, pkg, model, req in (
            ("port", T, pair.tmodel, tl.LoraRequest),
            ("folded", T, _fold_module(pair.tmodel, ad), None),
            ("jax", J, pair.tmodel, jl.LoraRequest),
            ("jax_base", J, pair.tmodel, None)):
        kw = _kw(pkg, max_beam_width=2)
        llm = pkg.LLM(model, device="cpu", **kw) if pkg is T else \
            pkg.LLM(model=model, **kw)
        try:
            if req is not None:
                llm.lora_manager.add_adapter(ad if pkg is J
                                             else _port_adapter(ad))
            out[name] = llm.generate_async(
                PROMPT, pkg.SamplingParams(**sp),
                lora_request=None if req is None else req("b", 12, "")
            ).result(60).outputs[0].token_ids
        finally:
            llm.shutdown()
    assert out["port"] == out["folded"]
    assert out["jax"] == out["jax_base"] != out["port"]


def test_refusals():
    from tensorrt_llm_tpu_torch.llmapi.llm_args import (
        LORA_DROPPED_MODEL_TYPES, check_lora_served)
    for name in ("gemma2", "gemma3_text"):
        with pytest.raises(NotImplementedError, match=f"{name}.*TypeError"):
            check_lora_served(name)
    for name in LORA_DROPPED_MODEL_TYPES:
        with pytest.raises(NotImplementedError, match=f"{name}.*drops"):
            check_lora_served(name)
    for name in ("gpt2", "deepseek_v3", "mamba", "bert", "gpt_oss",
                 "glm4_moe"):
        with pytest.raises(NotImplementedError, match=f"{name}.*refuses"):
            check_lora_served(name)
    for name in ("llama", "qwen3", "phi3", "llava", "qwen2_5_vl",
                 "qwen3_vl", "glm4v", "hunyuan_v1_dense"):
        check_lora_served(name)


def _tiny(kind):
    import transformers as tf
    base = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256)
    torch.manual_seed(0)
    if kind == "gemma2":
        return tf.Gemma2ForCausalLM(tf.Gemma2Config(head_dim=16, **base))
    if kind == "mixtral":
        return tf.MixtralForCausalLM(tf.MixtralConfig(
            num_local_experts=4, num_experts_per_tok=2, **base))
    return tf.GPT2LMHeadModel(tf.GPT2Config(
        vocab_size=96, n_embd=64, n_layer=2, n_head=4, n_positions=128))


@pytest.mark.parametrize("kind", ["gemma2", "mixtral", "gpt2"])
def test_refused_types_and_what_jax_does(kind):
    """The port refuses ``enable_lora`` on these types by name; the JAX
    ``LLM`` fails the adapter request (Gemma 2: TypeError in its
    forward), serves the base model's tokens for it (Mixtral), or refuses
    at construction (GPT-2)."""
    m = _tiny(kind)
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=2,
              max_input_len=32, max_seq_len=64, max_num_tokens=64,
              enable_lora=True,
              lora_config={"max_lora_rank": 4, "max_loras": 2})
    with pytest.raises(NotImplementedError, match=kind):
        T.LLM(m, device="cpu", kv_cache_config=T.KvCacheConfig(
            tokens_per_block=16, max_tokens=512), **kw)
    jkv = J.KvCacheConfig(tokens_per_block=16, max_tokens=512)
    if kind == "gpt2":
        with pytest.raises(NotImplementedError, match="LoRA not supported"):
            J.LLM(model=m, kv_cache_config=jkv, **kw)
        return
    llm = J.LLM(model=m, kv_cache_config=jkv, **kw)
    try:
        sp = J.SamplingParams(max_tokens=5, top_k=1)
        base = llm.generate(PROMPT, sp).outputs[0].token_ids
        rng = np.random.default_rng(1)
        llm.lora_manager.add_adapter(jl.LoraAdapter(7, 4, {"q": {
            layer: jl.LoraLayerWeights(
                a=rng.normal(size=(64, 4)).astype(np.float32),
                b=rng.normal(size=(4, 64)).astype(np.float32), scale=2.0)
            for layer in range(2)}}))
        llm.lora_manager.activate(7)
        llm.engine.refresh_lora()
        fut = llm.generate_async(PROMPT, sp,
                                 lora_request=jl.LoraRequest("a", 7, ""))
        if kind == "gemma2":
            with pytest.raises(TypeError, match="lora"):
                fut.result(60)
        else:
            assert fut.result(60).outputs[0].token_ids == base
    finally:
        llm.shutdown()


def test_lora_request_needs_enable_lora():
    from transformers import LlamaConfig
    cfg = LlamaConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=1, num_attention_heads=4,
                      num_key_value_heads=2)
    llm = T.LLM(cfg, device="cpu", **_kw(T, enable_lora=False))
    try:
        assert llm.lora_manager is None and llm.engine.lora_bytes == 0
        with pytest.raises(ValueError, match="enable_lora=False"):
            llm.generate(PROMPT, T.SamplingParams(max_tokens=2),
                         lora_request=tl.LoraRequest("a", 1, ""))
    finally:
        llm.shutdown()


def test_w4a16_base_with_an_adapter(monkeypatch, tmp_path):
    """A W4A16 base (the dequant-matmul kernel's plain version on the
    CPU, bf16 out) with an adapter on all seven modules: greedy tokens
    equal the JAX ``LLM``'s wherever the reference decides by more than
    the route's 3e-2 (tests/test_torch_quant_model.py), and the adapter
    moves them off the base's."""
    monkeypatch.setenv("TLLM_TPU_PALLAS_INTERPRET", "1")
    from transformers import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(0)
    cfg = LlamaConfig(vocab_size=128, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256)
    tm = LlamaForCausalLM(cfg).eval()
    ad = _all_modules_adapter(3, cfg, seed=9, scale=2.0)
    prompts = [PROMPT, [7, 3, 99, 4, 61, 17]]
    out = {}
    for name, pkg, extra, req in (
            ("jax", J, dict(model=tm), jl.LoraRequest),
            ("torch", T, dict(model=tm, device="cpu"), tl.LoraRequest)):
        llm = pkg.LLM(**extra, **_kw(pkg, quant_config=pkg.QuantConfig(
            quant_algo=pkg.QuantAlgo.W4A16_AWQ, group_size=64)))
        try:
            a = ad if pkg is J else _port_adapter(ad)
            llm.lora_manager.add_adapter(a)
            sp = pkg.SamplingParams(max_tokens=10, top_k=1, logprobs=2)
            outs = [llm.generate_async(p, sp, lora_request=lr).result(120)
                    for p in prompts for lr in (req("a", 3, ""), None)]
            out[name] = [o.outputs[0].token_ids for o in outs]
            out[name + "_lp"] = [o.outputs[0].logprobs for o in outs]
        finally:
            llm.shutdown()
    assert out["torch"][0] != out["torch"][1]
    agreed = 0
    for ref, got, lps in zip(out["jax"], out["torch"], out["jax_lp"]):
        for x, y, lp in zip(ref, got, lps):
            if x != y:
                top = sorted(lp.values(), reverse=True)
                assert top[0] - top[1] <= 3e-2, (ref, got, lp)
                break
            agreed += 1
    assert agreed >= 20          # of 40
