"""The port's Mllama (tensorrt_llm_tpu_torch/multimodal/mllama.py: the
tiled, gated vision tower, cross-attention layers over a slot-indexed
vision cache written at admission) against the JAX package and
transformers on the CPU, float32, the tiny config of tests/test_mllama.py
(gates set to 0.7 / 0.5 so that the cross layers are not a no-op):

- the tower and projector (2e-5 against the JAX tower, 3e-4 against
  transformers, as tests/test_mllama.py holds the JAX tower), each cross
  layer's K/V (1e-5);
- the prefill logits with the request's vision state in its slot (1e-4
  against the JAX forward and transformers with an all-ones cross mask);
- ``LLM.generate`` greedy tokens against the JAX ``LLM`` and transformers,
  then a text-only request in the recycled slot (one batch row), against
  transformers' text model;
- the reference faults (ROADMAP C): a prompt's rows in a chunk before its
  last read slot 0's vision state in the JAX engine (their ``seq_slots``
  is the step's ``out_slots``, -1 there); the JAX ``LLM`` submits an
  ``n = 2`` sibling without its cross states;
- the refusals (beam search, prompt logprobs, speculation) and the
  weights carried across (``from_jax_params``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorrt_llm_tpu as J
import tensorrt_llm_tpu_torch as T
from tensorrt_llm_tpu.models import ModelConfig as JConfig
from tensorrt_llm_tpu.models import get_model_class as jmodel
from tensorrt_llm_tpu_torch.models import (ModelConfig, from_jax_params,
                                           get_model_class)
from tensorrt_llm_tpu_torch.ops import attention as pattn
from tests.test_mllama import tiny_cfg
from tests.test_models import make_prefill_metadata

KV = dict(tokens_per_block=16, max_tokens=512)
LLM_KW = dict(skip_tokenizer_init=True, dtype="float32", max_batch_size=4,
              max_input_len=96, max_seq_len=128, max_num_tokens=128)
PROMPT = [2, 5, 250, 7, 9, 11]


class _Pair:
    def __init__(self):
        from transformers import MllamaForConditionalGeneration
        torch.manual_seed(0)
        cfg = tiny_cfg()
        self.hf = MllamaForConditionalGeneration(cfg).eval()
        with torch.no_grad():
            for li in (1, 3):
                lyr = self.hf.model.language_model.layers[li]
                lyr.cross_attn_attn_gate.fill_(0.7)
                lyr.cross_attn_mlp_gate.fill_(0.5)
        self.sd = {k: v.detach().float().numpy()
                   for k, v in self.hf.state_dict().items()}
        self.jm = jmodel("mllama")(JConfig(hf_config=cfg,
                                           dtype=jnp.float32))
        self.jm._num_slots = 4
        self.jp = self.jm.load_hf_state_dict(self.sd)
        self.m = get_model_class("mllama")(ModelConfig(
            hf_config=cfg, dtype=torch.float32, device="cpu"))
        self.p = self.m.load_hf_state_dict(
            {k: torch.tensor(v) for k, v in self.sd.items()})
        g = torch.Generator().manual_seed(1)
        self.images = [(torch.randn(1, 2, 3, 32, 32, generator=g),
                        torch.tensor([2]), torch.tensor([[1, 1]]))
                       for _ in range(2)]

    def mm(self, i=0):
        px, aid, am = self.images[i]
        return {"pixel_values": px.numpy(), "aspect_ratio_ids": aid.numpy(),
                "aspect_ratio_mask": am.numpy()}

    def hf_logits(self, ids, i=0):
        kw = {}
        if i is not None:
            px, aid, am = self.images[i]
            kw = dict(pixel_values=px[None], aspect_ratio_ids=aid[None],
                      aspect_ratio_mask=am[None],
                      cross_attention_mask=torch.ones(1, len(ids), 1, 2,
                                                      dtype=torch.long))
        with torch.no_grad():
            return self.hf(input_ids=torch.tensor([ids]),
                           **kw).logits[0].numpy()


@pytest.fixture(scope="module")
def pair():
    return _Pair()


def _states(pair, i=0):
    px, aid, am = pair.images[i]
    return pair.m.encode_images(px, aid, am)


def test_tower_and_cross_kv_match_jax_and_transformers(pair):
    px, aid, am = pair.images[0]
    got = _states(pair).numpy()
    want = np.asarray(pair.jm.encode_images(px.numpy(), aid.numpy(),
                                            am.numpy()))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    with torch.no_grad():
        v = pair.hf.model.vision_model(pixel_values=px[None],
                                       aspect_ratio_ids=aid[None],
                                       aspect_ratio_mask=am[None])
        ref = pair.hf.model.multi_modal_projector(v.last_hidden_state)
    np.testing.assert_allclose(got, ref.reshape(-1, got.shape[1]).numpy(),
                               rtol=3e-4, atol=3e-4)
    ks, vs = pair.m.compute_cross_kv(pair.p, torch.tensor(want))
    jks, jvs = pair.jm.compute_cross_kv(pair.jp, want)
    # the port keeps heads before positions: [n_cross, kvh, n, hd]
    np.testing.assert_allclose(ks.numpy(), np.asarray(jks).transpose(
        0, 2, 1, 3), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs).transpose(
        0, 2, 1, 3), rtol=1e-5, atol=1e-5)


def _port_logits(pair, ids, states, slot=2, params=None):
    """One prefill step of ``ids`` in sequence slot ``slot`` whose cross
    state is ``states`` (None: a text-only slot)."""
    m = pair.m
    cache = m.make_kv_pages(8, 16, num_slots=5)
    if states is not None:
        ks, vs = m.compute_cross_kv(params or pair.p, states)
        n = ks.shape[2]
        cache["cross_k"][:, slot, :, :n] = ks
        cache["cross_v"][:, slot, :, :n] = vs
        cache["cross_len"][slot] = n
    n = len(ids)
    i32 = dict(dtype=torch.int32)
    md = pattn.AttentionMetadata(
        kv_lens=torch.tensor([n], **i32),
        page_indices=torch.arange(8, **i32)[None],
        cu_q_lens=torch.tensor([0, n], **i32),
        num_seqs=torch.tensor([1], **i32), slot_mapping=torch.arange(n, **i32),
        positions=torch.arange(n, **i32), logits_indices=torch.arange(n),
        max_q_len=n, seq_slots=torch.tensor([slot], **i32))
    return m.forward(params or pair.p, torch.tensor(ids), cache,
                     md)[0].numpy()


def test_prefill_logits_match_jax_and_transformers(pair):
    states = _states(pair)
    got = _port_logits(pair, PROMPT, states)
    ks, vs = pair.jm.compute_cross_kv(pair.jp, states.numpy())
    cache = pair.jm.make_kv_pages(16, 16)
    n = ks.shape[1]
    cache["cross_k"] = cache["cross_k"].at[:, 0, :n].set(ks)
    cache["cross_v"] = cache["cross_v"].at[:, 0, :n].set(vs)
    cache["cross_len"] = cache["cross_len"].at[0].set(n)
    import dataclasses
    md = make_prefill_metadata(pair.jm, len(PROMPT))
    md = dataclasses.replace(
        md, seq_slots=jnp.asarray([0, -1], jnp.int32),
        logits_indices=jnp.arange(len(PROMPT), dtype=jnp.int32))
    jl, _ = pair.jm.forward(pair.jp, jnp.asarray(PROMPT, jnp.int32), cache,
                            md)
    np.testing.assert_allclose(got, np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, pair.hf_logits(PROMPT), rtol=1e-4,
                               atol=1e-4)
    # a text-only slot passes the cross layers through: transformers
    # without an image
    np.testing.assert_allclose(_port_logits(pair, PROMPT, None),
                               pair.hf_logits(PROMPT, None), rtol=1e-4,
                               atol=1e-4)


def _greedy_hf(pair, ids, n, i=0):
    cur, out = list(ids), []
    for _ in range(n):
        nxt = int(np.argmax(pair.hf_logits(cur, i)[-1]))
        out.append(nxt)
        cur.append(nxt)
    return out


def test_llm_greedy_then_text_only_in_the_recycled_slot(pair):
    """One batch row, so the text-only request takes the image request's
    slot: the image request's tokens equal the JAX ``LLM``'s and
    transformers'; the text-only one's equal transformers' text model
    (the admission cleared the slot's vision state)."""
    sp = dict(max_tokens=6, top_k=1, end_id=-1)
    img = {"prompt_token_ids": PROMPT, "multi_modal_data": pair.mm()}
    text = [3, 7, 12, 19]
    j = J.LLM(model=pair.hf, kv_cache_config=J.KvCacheConfig(**KV),
              **dict(LLM_KW, max_batch_size=1))
    try:
        jw = [j.generate(p, J.SamplingParams(**sp)).outputs[0].token_ids
              for p in (img, text)]
    finally:
        j.shutdown()
    llm = T.LLM(pair.hf, device="cpu", kv_cache_config=T.KvCacheConfig(**KV),
                **dict(LLM_KW, max_batch_size=1))
    try:
        got = [llm.generate(p, T.SamplingParams(**sp)).outputs[0].token_ids
               for p in (img, text)]
        assert int(llm.engine.kv_pages["cross_len"][0]) == 0
        windows = llm.engine.window_steps
    finally:
        llm.shutdown()
    assert got == jw
    assert got[0] == _greedy_hf(pair, PROMPT, 6)
    assert got[1] == _greedy_hf(pair, text, 6, None)
    assert windows > 0


def test_chunked_prompts_read_their_own_slot_where_jax_reads_slot_0(pair):
    """Two image requests with different images, prompts longer than a
    64-token chunk. The port's rows of the first chunk read their own
    slot; the JAX engine's read slot 0 (``seq_slots`` = ``out_slots``, -1
    in a chunk before the last, clipped to 0), so the request in slot 1
    attends to the other request's image there (ROADMAP C)."""
    rng = np.random.default_rng(5)
    prompts = [{"prompt_token_ids": [2, 250] + rng.integers(
        3, 240, 80).tolist(), "multi_modal_data": pair.mm(i)}
        for i in range(2)]
    sp = dict(max_tokens=3, top_k=1, end_id=-1, logprobs=2)

    def first_lps(outs):
        return [o.outputs[0].logprobs[0] for o in outs]

    def run(make, SP, batch):
        llm = make()
        try:
            if batch:
                return first_lps(llm.generate(prompts, SP(**sp)))
            return first_lps([llm.generate(p, SP(**sp)) for p in prompts])
        finally:
            llm.shutdown()

    kw = dict(LLM_KW, max_num_tokens=64)
    port = lambda: T.LLM(pair.hf, device="cpu",  # noqa: E731
                         kv_cache_config=T.KvCacheConfig(**KV), **kw)
    jaxl = lambda: J.LLM(model=pair.hf,  # noqa: E731
                         kv_cache_config=J.KvCacheConfig(**KV), **kw)
    alone = run(port, T.SamplingParams, False)
    together = run(port, T.SamplingParams, True)
    assert all(_close(a, b) for a, b in zip(alone, together))
    jalone = run(jaxl, J.SamplingParams, False)
    jtogether = run(jaxl, J.SamplingParams, True)
    assert _close(jalone[0], alone[0]) and _close(jalone[1], alone[1])
    assert _close(jtogether[0], alone[0])
    assert not _close(jtogether[1], alone[1], 1e-3)


def _close(a, b, tol=1e-4):
    """Two {token: logprob} dicts with the same tokens, within ``tol``."""
    return set(a) == set(b) and all(abs(a[t] - b[t]) < tol for t in a)


def test_n2_samples_carry_the_cross_states(pair):
    """``n = 2``: the port's second sample carries the vision state, so
    its first token's log-probabilities equal the first sample's; the JAX
    ``LLM`` submits it without (llm.py:844-866), so its second sample's
    are the text-only prompt's (ROADMAP C)."""
    sp = dict(max_tokens=2, top_k=1, end_id=-1, logprobs=3)
    prompt = {"prompt_token_ids": PROMPT, "multi_modal_data": pair.mm()}
    llm = T.LLM(pair.hf, device="cpu", kv_cache_config=T.KvCacheConfig(**KV),
                **LLM_KW)
    try:
        got = [o.logprobs[0] for o in llm.generate(
            prompt, T.SamplingParams(n=2, **sp)).outputs]
        text = llm.generate(PROMPT, T.SamplingParams(**sp)) \
            .outputs[0].logprobs[0]
    finally:
        llm.shutdown()
    j = J.LLM(model=pair.hf, kv_cache_config=J.KvCacheConfig(**KV),
              **LLM_KW)
    try:
        jgot = [o.logprobs[0] for o in j.generate(
            prompt, J.SamplingParams(n=2, **sp)).outputs]
    finally:
        j.shutdown()
    assert not _close(got[0], text, 1e-3)
    assert _close(got[0], got[1])
    assert _close(jgot[0], got[0]) and _close(jgot[1], text)


def test_image_prompts_refuse_what_takes_no_cross_state(pair):
    from tensorrt_llm_tpu_torch.llmapi.llm_args import (SpeculativeConfig,
                                                        check_ported_spec)
    prompt = {"prompt_token_ids": PROMPT, "multi_modal_data": pair.mm()}
    llm = T.LLM(pair.hf, device="cpu", kv_cache_config=T.KvCacheConfig(**KV),
                **LLM_KW)
    try:
        with pytest.raises(NotImplementedError, match="beam search"):
            llm.generate(prompt, T.SamplingParams(
                max_tokens=2, use_beam_search=True, best_of=2, n=1))
        with pytest.raises(ValueError, match="prompt_logprobs"):
            llm.generate(prompt, T.SamplingParams(max_tokens=2,
                                                  prompt_logprobs=1))
    finally:
        llm.shutdown()
    for name in ("mllama", "gemma3", "gemma3_vl", "paligemma"):
        with pytest.raises(NotImplementedError, match=name):
            check_ported_spec(SpeculativeConfig(mode="NGRAM",
                                                max_draft_len=2), name)


def test_weights_carried_across_from_jax(pair):
    m = get_model_class("mllama")(ModelConfig(
        hf_config=pair.hf.config, dtype=torch.float32, device="cpu"))
    params = from_jax_params(
        jax.tree.map(np.asarray, pair.jp), model=m,
        vision=jax.tree.map(np.asarray, pair.jm._vision_params),
        projector=jax.tree.map(np.asarray, pair.jm._projector))
    px, aid, am = pair.images[0]
    states = m.encode_images(px, aid, am)
    np.testing.assert_allclose(states.numpy(), _states(pair).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _port_logits(pair, PROMPT, states, params=params),
        _port_logits(pair, PROMPT, _states(pair)), rtol=1e-5, atol=1e-5)



EVICT_KV = dict(tokens_per_block=16, max_tokens=48, enable_block_reuse=False)


def _evicting_run(pair, pkg, sp):
    """Two image requests (different images) through ``pkg``'s ``LLM``,
    whose pool (3 blocks of 16) holds one of them to its end but not
    both, under MAX_UTILIZATION and without prefix reuse (a resumed
    request recomputes its whole sequence). Returns each request's
    tokens and the request's output count at its first pause (None:
    never paused)."""
    prompts = [{"prompt_token_ids": [2, 250, 5 + i, 7, 9, 11],
                "multi_modal_data": pair.mm(i)} for i in range(2)]
    if pkg is T:
        from tensorrt_llm_tpu_torch.llmapi.llm_args import SchedulerConfig
        from tensorrt_llm_tpu_torch.runtime.scheduler import \
            CapacitySchedulerPolicy
        llm = T.LLM(pair.hf, device="cpu", **LLM_KW,
                    kv_cache_config=T.KvCacheConfig(**EVICT_KV),
                    scheduler_config=SchedulerConfig(
                        capacity_scheduler_policy=CapacitySchedulerPolicy
                        .MAX_UTILIZATION))
    else:
        from tensorrt_llm_tpu.llmapi.llm_args import SchedulerConfig
        from tensorrt_llm_tpu.runtime.scheduler import \
            CapacitySchedulerPolicy
        llm = J.LLM(model=pair.hf, **LLM_KW,
                    kv_cache_config=J.KvCacheConfig(**EVICT_KV),
                    scheduler_config=SchedulerConfig(
                        capacity_scheduler_policy=CapacitySchedulerPolicy
                        .MAX_UTILIZATION))
    ex = llm.executor
    first = {}
    pause = ex._pause_requests

    def record(paused, batch):
        pause(paused, batch)         # drains the steps in flight first
        for r in paused:
            if not r.is_finished:
                first.setdefault(r.request_id, r.num_output_tokens)
    ex._pause_requests = record
    try:
        outs = llm.generate(prompts, pkg.SamplingParams(**sp))
    finally:
        llm.shutdown()
    return ([o.outputs[0].token_ids for o in outs],
            [first.get(o.request_id) for o in outs],
            [p["prompt_token_ids"] for p in prompts])


EVICT_SP = dict(max_tokens=30, top_k=1, end_id=-1)


def test_evicted_request_keeps_its_image(pair):
    """A request paused under memory pressure and admitted again writes
    its vision state into its new slot: both requests' tokens equal
    transformers' greedy tokens with their images, one of them paused."""
    toks, paused, prompts = _evicting_run(pair, T, EVICT_SP)
    assert any(k is not None for k in paused)
    for i, (t, ids) in enumerate(zip(toks, prompts)):
        assert t == _greedy_hf(pair, ids, EVICT_SP["max_tokens"], i)


def test_jax_decodes_an_evicted_requests_tail_as_text(pair):
    """The JAX executor drops a request's cross states at admission
    (executor.py:1127-1135), so a paused request comes back text-only:
    its tokens past the pause are transformers' greedy continuation of
    the text model, not the image model's (ROADMAP C)."""
    toks, paused, prompts = _evicting_run(pair, J, EVICT_SP)
    n = EVICT_SP["max_tokens"]
    hit = [i for i, k in enumerate(paused) if k is not None]
    assert hit
    for i in hit:
        k = paused[i]
        assert toks[i][:k] == _greedy_hf(pair, prompts[i], n, i)[:k]
        assert toks[i][k:] == _greedy_hf(pair, prompts[i] + toks[i][:k],
                                         n - k, None)
        assert toks[i] != _greedy_hf(pair, prompts[i], n, i)
