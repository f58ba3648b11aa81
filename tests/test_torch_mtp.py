"""MTP speculation on the MLA targets and EAGLE3's host path, against the
JAX package, float32, CPU.

The MTP drafter (speculative/mtp.py) against the JAX ``MtpDrafter`` on
the tiny DeepSeek-V3 of tests/test_deepseek.py::tiny_cfg and a V2 without
q_lora_rank (the setup of tests/test_speculative.py::
test_mtp_drafter_unit): the same synthesized head, the same target
weights (``from_jax_params``), the same feature streams give the same
drafts over a slot lifecycle (a request dropped, its slot taken again).
The JAX drafters attend work row i over slot i's pages, the port over
the request's own slot: a request drafted alone from slot 1 gets the
drafts it gets beside another request from the port, and others from
the JAX package. One fused window with the MTP head gives JAX
``build_spec_window``'s tokens, counts and state from the same state.

Through ``LLM``: MTP on V3 and V2, in the fused window and on the host
path, gives the non-speculative greedy tokens and the JAX MTP run's; a
seeded sampled MTP run serves the non-speculative seeded tokens; EAGLE3
on the host path gives the non-speculative and the JAX host path's
tokens with the JAX drafter's drafts (the setup of tests/
test_speculative.py::test_e2e_eagle3_lossless). MTP on a target without
an MLA pool, EAGLE3 trees and DFLASH are refused by name.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

PROMPTS = [[5, 9, 23, 44, 17], [3, 3, 7, 3, 3, 7, 3, 3]]


def _v3_cfg():
    from tests.test_deepseek import tiny_cfg
    return tiny_cfg()


def _v2_cfg():
    from transformers import DeepseekV2Config
    return DeepseekV2Config(
        vocab_size=96, hidden_size=64, intermediate_size=128,
        moe_intermediate_size=48, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4, n_routed_experts=4,
        num_experts_per_tok=2, n_shared_experts=1, q_lora_rank=None,
        kv_lora_rank=16, qk_rope_head_dim=8, qk_nope_head_dim=16,
        v_head_dim=16, first_k_dense_replace=1, topk_method="greedy",
        n_group=1, topk_group=1, routed_scaling_factor=1.0,
        max_position_embeddings=256)


CFGS = {"v3": _v3_cfg, "v2": _v2_cfg}


def _hf(kind):
    import transformers as tf
    cls = tf.DeepseekV3ForCausalLM if kind == "v3" else \
        tf.DeepseekV2ForCausalLM
    torch.manual_seed(0)
    return cls(CFGS[kind]()).eval()


@pytest.fixture(scope="module", params=["v3", "v2"])
def targets(request):
    from tensorrt_llm_tpu.models import ModelConfig as JConfig
    from tensorrt_llm_tpu.models import get_model_class as jget
    from tensorrt_llm_tpu_torch.models import ModelConfig as TConfig
    from tensorrt_llm_tpu_torch.models import from_jax_params
    from tensorrt_llm_tpu_torch.models import get_model_class as tget
    cfg = CFGS[request.param]()
    jm = jget(cfg.model_type)(JConfig(hf_config=cfg, dtype=jnp.float32))
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tm = tget(cfg.model_type)(TConfig(hf_config=cfg, dtype=torch.float32,
                                      device="cpu"))
    return jm, jparams, tm, from_jax_params(jax.tree.map(np.asarray,
                                                         jparams))


def _drafters(targets, n=1):
    from tensorrt_llm_tpu.speculative.mtp import MtpDrafter as JMtp
    from tensorrt_llm_tpu_torch.speculative.mtp import MtpDrafter as TMtp
    jm, jparams, tm, tparams = targets
    kw = dict(max_draft_len=3, max_slots=4, page_size=16, max_seq_len=64,
              token_buckets=(16,))
    return [(JMtp(jm, jparams, **kw), TMtp(tm, tparams, **kw))
            for _ in range(n)]


def _req(pkg, prompt):
    if pkg == "jax":
        from tensorrt_llm_tpu.runtime.request import LlmRequest
        from tensorrt_llm_tpu.sampling_params import SamplingParams
    else:
        from tensorrt_llm_tpu_torch.runtime.request import LlmRequest
        from tensorrt_llm_tpu_torch.sampling_params import SamplingParams
    return LlmRequest(prompt_token_ids=list(prompt),
                      sampling_params=SamplingParams(max_tokens=32))


def _feats(rng, n, H):
    return [(int(rng.integers(0, 96)),
             rng.standard_normal(H).astype(np.float32)) for _ in range(n)]


def _draft(jd, td, streams):
    """Both drafters over the same {name: (request pair, pending pairs)};
    returns {name: (JAX drafts, port drafts)}."""
    for (jr, tr), feats in streams.values():
        jr.eagle_feats = list(feats)
        tr.eagle_feats = list(feats)
    jd.prepare_draft_tokens([p[0] for p, _ in streams.values()])
    td.prepare_draft_tokens([p[1] for p, _ in streams.values()])
    for (jr, tr), _ in streams.values():
        assert jr.eagle_feats == [] and tr.eagle_feats == []
    return {k: (p[0].draft_tokens, p[1].draft_tokens)
            for k, (p, _) in streams.items()}


def test_head_parameters_match_jax(targets):
    """The synthesized head (the JAX ``_synth_state_dict``'s draws)
    through the target's layer loader: the JAX head's tensors; the
    embedding and lm_head borrowed from the target, not copied."""
    (jd, td), = _drafters(targets)
    jm, jparams, tm, tparams = targets
    jp, tp = jd.params, td.params
    np.testing.assert_array_equal(tp["eh_proj"].numpy(),
                                  np.asarray(jp["eh_proj"]).T)
    np.testing.assert_array_equal(tp["kv_b"]["weight"].numpy(),
                                  np.asarray(jp["kv_b"]["weight"]).T)
    np.testing.assert_array_equal(
        tp["w_gate_up"].numpy(),
        np.concatenate([jp["w_gate"], jp["w_up"]], axis=-1))
    np.testing.assert_array_equal(tp["router"].numpy(),
                                  np.asarray(jp["router"]).T)
    for name in ("enorm", "hnorm", "head_norm"):
        np.testing.assert_array_equal(tp[name].numpy(), np.asarray(jp[name]))
    assert td.embed.data_ptr() == tparams["embed"].data_ptr()
    assert td.lm_head["weight"].data_ptr() == \
        tparams["lm_head"]["weight"].data_ptr()
    assert td.kv.shape == (4 * 4, 16, tm.latent_dim)


def test_drafts_match_jax_over_a_slot_lifecycle(targets):
    """Two requests (2 and 1 pending pairs), then more pairs at their next
    positions, then one dropped and a new request in its slot: drafts
    equal the JAX drafter's each time, with the same slots and
    positions."""
    (jd, td), = _drafters(targets)
    H = targets[2].hidden_size
    rng = np.random.default_rng(0)
    a = (_req("jax", [1, 2, 3]), _req("torch", [1, 2, 3]))
    b = (_req("jax", [4, 5]), _req("torch", [4, 5]))
    rounds = [{"a": (a, _feats(rng, 2, H)), "b": (b, _feats(rng, 1, H))},
              {"a": (a, _feats(rng, 3, H)), "b": (b, _feats(rng, 2, H))}]
    for streams in rounds:
        for name, (j, t) in _draft(jd, td, streams).items():
            assert len(t) == 3 and all(0 <= x < 96 for x in t)
            assert t == j, name
    assert td._state == {a[1].request_id: (0, 5), b[1].request_id: (1, 3)}
    jd.drop_request(b[0].request_id)
    td.drop_request(b[1].request_id)
    assert sorted(td._free) == [1, 2, 3]
    c = (_req("jax", [7, 8, 9]), _req("torch", [7, 8, 9]))
    got = _draft(jd, td, {"a": (a, _feats(rng, 1, H)),
                          "c": (c, _feats(rng, 2, H))})
    assert td._state[c[1].request_id] == (1, 2)
    for name, (j, t) in got.items():
        assert t == j, name


def test_drafter_reads_its_own_slot_where_jax_reads_the_row(targets):
    """A request in slot 1 drafted alone (work row 0) and beside the
    request of slot 0 (work row 1): the port's drafts are the same; the
    JAX drafter's alone attend slot 0's history (its page table row 0)
    and differ."""
    pairs = _drafters(targets, 2)
    H = targets[2].hidden_size
    rng = np.random.default_rng(2)
    first = {"a": _feats(rng, 4, H), "c": _feats(rng, 3, H)}
    second = {"a": _feats(rng, 1, H), "c": _feats(rng, 2, H)}
    out = []
    for alone, (jd, td) in zip((True, False), pairs):
        reqs = {k: (_req("jax", [1, 2]), _req("torch", [1, 2]))
                for k in ("a", "c")}
        _draft(jd, td, {k: (reqs[k], first[k]) for k in ("a", "c")})
        names = ("c",) if alone else ("a", "c")
        out.append(_draft(jd, td, {k: (reqs[k], second[k])
                                   for k in names})["c"])
    (j_alone, t_alone), (j_beside, t_beside) = out
    assert t_alone == t_beside
    assert j_beside == t_beside
    assert j_alone != j_beside


def test_window_dispatch_matches_jax(targets):
    """One fused window (K = 2, d = 2, 4 rows: 3 live in slots 2, 0, 3 and
    a padding row) with the MTP head, from the same random target and head
    latent pools, pending pairs and positions, against JAX
    ``build_spec_window`` on a stand-in JAX engine: tokens, counts and
    integer state equal, logprobs within 1e-5, the pending features
    within 1e-4 + 1e-5 relative."""
    from types import SimpleNamespace

    from tensorrt_llm_tpu.runtime import spec_window as jspec
    from tensorrt_llm_tpu.speculative.mtp import MtpDrafter as JMtp
    from tensorrt_llm_tpu_torch.llmapi.llm_args import (KvCacheConfig,
                                                        LlmArgs)
    from tensorrt_llm_tpu_torch.runtime import spec_window as tspec
    from tensorrt_llm_tpu_torch.runtime.cuda_graph import upload
    from tensorrt_llm_tpu_torch.runtime.model_engine import ModelEngine
    from tensorrt_llm_tpu_torch.speculative.mtp import MtpDrafter as TMtp
    from tests.test_torch_spec import MAX_SEQ, NP, PS, S, _window_state
    jm, jparams, tm, tparams = targets
    d, K, Sb, Dp = 2, 2, S, 3
    jd = JMtp(jm, jparams, max_draft_len=d, max_slots=1, page_size=32,
              max_seq_len=MAX_SEQ)
    td = TMtp(tm, tparams, max_draft_len=d, max_seq_len=MAX_SEQ)
    st, rng = _window_state(d, seed=4)
    H = tm.hidden_size
    pool = (rng.standard_normal(tm.kv_pool_shape(NP, PS)) * 0.5) \
        .astype(np.float32)
    feats = rng.standard_normal((S, Dp, H)).astype(np.float32)
    P_h = MAX_SEQ // 32
    hkv = (rng.standard_normal((S * P_h, 32) + td.kv_entry_shape) * 0.5) \
        .astype(np.float32)
    stop_ids = np.full((Sb, 8), -1, np.int32)

    jeng = SimpleNamespace(max_batch_size=S, model=jm, max_seq_len=MAX_SEQ,
                           page_size=PS, pages_per_seq=MAX_SEQ // PS,
                           num_kv_pages=NP, NSTOP=8, sd=None)
    jspec.enable_spec_device(jeng, jd, d, K)
    sd = jeng.sd
    ints = np.zeros((7, Sb), np.int32)
    ints[:4] = [st["slots"], st["budget"], st["max_tok"], st["min_tok"]]
    ints[5] = 1
    z1 = jnp.zeros((1,), jnp.int32)
    fn = jspec.build_spec_window(jeng, K, Sb, True, False, 0)
    jout = fn(jparams, jnp.asarray(pool), jnp.zeros((S,), jnp.int32),
              jnp.asarray(ints), jnp.asarray(stop_ids),
              jnp.asarray(st["page_indices"]),
              jnp.ones((6, Sb), jnp.float32), 1, sd.head_params,
              jnp.asarray(hkv), sd.embed_w, sd.lm_head_w,
              jnp.asarray(st["pend_toks"] % 96), jnp.asarray(feats),
              jnp.asarray(st["pend_n"]), jnp.asarray(st["pos_h"]),
              jnp.asarray(st["pos_t"]), jnp.asarray(st["emitted_t"]),
              z1, jnp.zeros((1, 1), jnp.int16), jnp.zeros((1, 1), jnp.uint8),
              jnp.zeros((1,), bool), jnp.zeros((1, 1), jnp.uint8), z1)
    (jtoks, jlps, jcounts, jwin, _, jprev, _, jpt, jpf, jpn, jph, jpos,
     jemit, _, _, _) = [np.asarray(x) for x in jout]

    args = LlmArgs(model="deepseek", dtype="float32", max_batch_size=S,
                   max_input_len=64, max_seq_len=MAX_SEQ,
                   kv_cache_config=KvCacheConfig(tokens_per_block=PS))
    eng = ModelEngine(tm, tparams, args, num_kv_pages=NP)
    eng.kv_pages.copy_(torch.from_numpy(pool))
    tspec.enable_spec_device(eng, td, d, K)
    t = eng.sd
    t.kv.copy_(torch.from_numpy(hkv))
    t.pend_toks[:S] = torch.from_numpy(st["pend_toks"] % 96).long()
    t.pend_feats[:S] = torch.from_numpy(feats)
    for name in ("pend_n", "pos_h", "pos_t", "emitted_t"):
        getattr(t, name)[:S] = torch.from_numpy(st[name])
    inputs = dict(ints=ints[:4].copy(), seeds=np.zeros(Sb, np.int32),
                  stop_ids=stop_ids, page_indices=st["page_indices"])
    body = tspec.build_spec_window(eng, K, Sb, True, False, 0,
                                   eng.head_kv_bound(MAX_SEQ),
                                   eng._kv_bound(MAX_SEQ))
    out = [x.numpy() for x in body(upload(inputs, eng.device))]

    np.testing.assert_array_equal(out[0], jtoks)
    np.testing.assert_array_equal(out[2], jcounts)
    np.testing.assert_array_equal(out[3], jwin)
    np.testing.assert_allclose(out[1], jlps, atol=1e-5)
    assert jcounts[:, 3].sum() == 0 and jcounts[:, :3].all(axis=1).any()
    np.testing.assert_array_equal(t.pend_toks[:S].numpy(), jpt)
    np.testing.assert_allclose(t.pend_feats[:S].numpy(), jpf, atol=1e-4,
                               rtol=1e-5)
    for name, want in (("pend_n", jpn), ("pos_h", jph), ("pos_t", jpos),
                       ("emitted_t", jemit)):
        np.testing.assert_array_equal(getattr(t, name)[:S].numpy(), want)
    np.testing.assert_array_equal(eng.prev_tokens[:S].numpy(), jprev)


# ---- through LLM ---------------------------------------------------------

def _kw(**over):
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=64, max_seq_len=128, max_num_tokens=256)
    kw.update(over)
    return kw


def _run(pkg, model, sp_kw=None, **kw):
    """Tokens of ``PROMPTS`` (10 each) through one ``LLM``, and it."""
    if pkg == "jax":
        import tensorrt_llm_tpu as P
        from tensorrt_llm_tpu.llmapi.llm_args import SpeculativeConfig
        llm_kw = {}
    else:
        import tensorrt_llm_tpu_torch as P
        from tensorrt_llm_tpu_torch import SpeculativeConfig
        llm_kw = dict(device="cpu")
    spec = kw.pop("spec", None)
    if spec is not None:
        kw["speculative_config"] = SpeculativeConfig(**spec)
    sp = P.SamplingParams(**(sp_kw or dict(max_tokens=10, top_k=1)))
    llm = P.LLM(model=model, kv_cache_config=P.KvCacheConfig(
        tokens_per_block=16, max_tokens=2048), **_kw(**kw), **llm_kw)
    try:
        toks = [o.outputs[0].token_ids for o in llm.generate(PROMPTS, sp)]
        return toks, llm
    finally:
        llm.shutdown()


@pytest.fixture(scope="module", params=["v3", "v2"])
def served(request):
    hf = _hf(request.param)
    base, _ = _run("torch", hf)
    return request.param, hf, base


@pytest.mark.parametrize("window", [True, False])
def test_llm_mtp_tokens_equal_plain_and_jax(served, window):
    """MTP (d = 2, a seeded random head: acceptance near 0) is lossless,
    in the window (its verify and catch-up on MLA's decompressed path,
    graph keys carrying both KV bounds) and on the host path (drafts
    proposed every step), and gives the JAX MTP run's tokens."""
    from tensorrt_llm_tpu_torch.models import deepseek
    kind, hf, base = served
    spec = dict(mode="MTP", max_draft_len=2, device_window=window)
    d0 = deepseek.MLA_DECOMPRESSED
    got, llm = _run("torch", hf, spec=spec)
    if window:
        assert llm.engine.sd.windows > 0
        assert llm.executor.nonspec_decode_rows == 0
        keys = [k for k in llm.engine.graphs.steps if k[0] == "spec"]
        assert keys and all(k[6][0] == "kv_bound" and k[7][0] == "kv_bound"
                            for k in keys)
    else:
        assert llm.engine.sd is None
        assert llm.executor.drafts_proposed >= 2 * 8
    assert deepseek.MLA_DECOMPRESSED > d0
    want, _ = _run("jax", hf, spec=dict(spec))
    assert got == base
    assert got == want


def test_llm_mtp_seeded_sampled_serves_the_plain_tokens(served):
    """A seeded sampled MTP window (temperature 0.8) serves 10 in-vocab
    tokens a prompt: the position-keyed samples of the non-speculative
    seeded run."""
    _, hf, _ = served
    sp = dict(max_tokens=10, temperature=0.8, top_k=0, seed=17)
    plain, _ = _run("torch", hf, sp_kw=sp)
    got, _ = _run("torch", hf, sp_kw=sp,
                  spec=dict(mode="MTP", max_draft_len=2))
    assert all(len(t) == 10 and all(0 <= x < 96 for x in t) for t in got)
    assert got == plain


def test_mtp_head_pool_carved_before_the_target_pool():
    """The window's head pool (the MLA latent a position and slot) and
    pending features are counted off the KV budget; the head's weights
    are on the device before the engine is built."""
    from tensorrt_llm_tpu_torch.runtime.spec_window import head_pool_bytes
    _, llm = _run("torch", _hf("v3"), spec=dict(mode="MTP",
                                                max_draft_len=1))
    e = llm.engine
    want = head_pool_bytes(4, 128, 1, 64, e.model.latent_dim, 4)
    assert e.spec_state_bytes() == want
    assert e.sd.kv.shape[1:] == (32, e.model.latent_dim)
    assert e.sd.kv.numel() * 4 + e.sd.pend_feats.numel() * 4 == want


# ---- EAGLE3 on the host path ----------------------------------------------

@pytest.fixture(scope="module")
def repeat_model():
    from transformers import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(3)
    cfg = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=512)
    return LlamaForCausalLM(cfg).eval()


def _recording(drafter, log):
    """Wrap ``prepare_draft_tokens`` to log each call's drafts by
    prompt."""
    inner = drafter.prepare_draft_tokens

    def wrapped(requests):
        inner(requests)
        log.append({tuple(r.prompt_token_ids): list(r.draft_tokens)
                    for r in requests})
    drafter.prepare_draft_tokens = wrapped


def test_eagle3_host_path_matches_jax(repeat_model):
    """EAGLE3 (d = 3, the seeded random head) with device_window=False:
    three prompts, 14 tokens each, give the non-speculative tokens and the
    JAX host path's, with the JAX drafter's drafts at every step."""
    import tensorrt_llm_tpu as J
    import tensorrt_llm_tpu_torch as T
    from tensorrt_llm_tpu.llmapi.llm_args import SpeculativeConfig as JSC
    prompts = [[5, 9, 23, 44, 17], [3, 3, 7, 3, 3, 7, 3, 3], [11] * 12]
    kw = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=8,
              max_input_len=64, max_seq_len=128, max_num_tokens=256)
    spec = dict(mode="EAGLE3", max_draft_len=3, device_window=False)
    logs = {"jax": [], "torch": []}
    out = {}
    for name, P, sc in (("torch", T, T.SpeculativeConfig(**spec)),
                        ("jax", J, JSC(**spec)), ("plain", T, None)):
        extra = {} if name == "jax" else dict(device="cpu")
        llm = P.LLM(model=repeat_model, speculative_config=sc,
                    kv_cache_config=P.KvCacheConfig(tokens_per_block=16,
                                                    max_tokens=2048),
                    **kw, **extra)
        try:
            if name in logs:
                _recording(llm.executor.drafter, logs[name])
            out[name] = [o.outputs[0].token_ids for o in llm.generate(
                prompts, P.SamplingParams(max_tokens=14, top_k=1))]
        finally:
            llm.shutdown()
    assert out["torch"] == out["plain"] == out["jax"]
    assert len(logs["torch"]) >= 13
    assert logs["torch"] == logs["jax"]


# ---- refusals ------------------------------------------------------------

@pytest.mark.parametrize("model,spec,name", [
    ("llama", dict(mode="MTP"), "MTP with a llama target"),
    ("llama", dict(mode="EAGLE3", device_window=False, eagle_tree_width=2),
     "eagle_tree_width"),
    ("llama", dict(mode="EAGLE3", device_window=False,
                   eagle_dynamic_tree=True), "eagle_dynamic_tree"),
    ("v3", dict(mode="DFLASH"), "DFLASH"),
    ("v3", dict(mode="EAGLE3"), "EAGLE3 with a deepseek_v3 target"),
])
def test_refused_by_name(model, spec, name):
    from transformers import LlamaConfig

    import tensorrt_llm_tpu_torch as T
    cfg = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2) if model == "llama" \
        else CFGS[model]()
    with pytest.raises(NotImplementedError, match=name):
        T.LLM(cfg, device="cpu", **_kw(), speculative_config=
              T.SpeculativeConfig(max_draft_len=2, **spec))
